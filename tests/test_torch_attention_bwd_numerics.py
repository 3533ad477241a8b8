"""The bfloat16 ``flash_attention_bwd`` kernel's arithmetic, emulated in
plain PyTorch on the CPU and held to the gate the card holds the kernel
to, and its launch plan.

The tensor-core kernel (``csrc/flash_attention_bwd.cu``) runs only on the
card, but where it rounds can be emulated on the CPU: bf16 operands
multiplied exactly into float32 scores and dP, the scale applied to the
float32 scores, the softcap as ``cap tanh(s / cap)`` with 1 / cap
multiplied in, ``p = 2^((s - lse) log2 e)``, ``dS = P (dP - delta)``
times the softcap's factor, then P and dS split into bf16 ``hi`` and
``lo`` for the products with dO, Q and K. dQ sums its key tiles in
order; dK and dV sum, per key tile, the q heads of a split's group and
the query tiles of its part in order, and the splits' float32 partials
are added in the plan's order.
:func:`kernel_emulation` does exactly that, and the tests hold it within
the bf16 gate of ``tests/test_torch_cuda.py::assert_close_to_plain`` (2
bf16 ulps of max(|want|, max|want| / 256)) of the port's plain version,
``flash_attention_bwd_torch``, at small gemma2-, paligemma-, hubert- and
MLA-like shapes, and of the reference's own backward.

Two negative controls record why the kernel splits both operands: one
bf16 P (dV off) and one bf16 dS (dQ and dK off, where
``dQ = sum_j dS_ij k_j`` cancels) each fail that gate at a stated
shape.

Inputs are drawn with NumPy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.kernels.flash_attention import (
    BWD_STREAM, SMS, bwd_fixed_rows, bwd_plan, bwd_shared_bytes,
    flash_attention_bwd_torch, flash_attention_torch, visible)

LOG2E = 1.4426950408889634
SM_SHARED_BYTES = 233_472           # shared memory of one H100 SM
CTA_RESERVED_BYTES = 1_024          # shared memory the system keeps a block


def gate_ratio(got, want):
    """Largest error over the bf16 gate's bound (<= 1 passes): 2 bf16
    ulps of max(|want|, max|want| / 256)."""
    g, w = got.double(), want.double()
    amax = float(w.abs().max())
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    bound = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / bound).max())


def split(x, on):
    """bf16 hi and lo of float32 ``x`` as float32 (lo None when not
    ``on``: one bf16 rounding)."""
    hi = x.bfloat16().float()
    return hi, ((x - hi).bfloat16().float() if on else None)


def products(w, rhs):
    """``w`` as (hi, lo) times ``rhs``: the hi product, then the lo one."""
    out = w[0] @ rhs
    return out if w[1] is None else out + w[1] @ rhs


def kernel_emulation(q, k, v, out, dout, lse, *, causal=True, window=None,
                     softcap=None, prefix_len=None, split_p=True,
                     split_ds=True):
    """The tensor-core kernel's rounding on bf16 (B, S, H, D) inputs
    with the forward's ``out`` and ``lse``: returns (dq, dk, dv) bf16.
    ``split_p`` / ``split_ds`` False: that operand as one bf16 (the
    negative controls)."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5
    plan = bwd_plan(b, s, hq, hkv, d, dv)
    f, t = bwd_fixed_rows(d, dv), BWD_STREAM
    qf = q.float().view(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)
    dof = dout.float().view(b, s, hkv, g, dv).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    delta = (dout.float() * out.float()).sum(-1).view(b, s, hkv, g) \
        .permute(0, 2, 3, 1)
    sc = (qf @ kf.transpose(-1, -2)) * scale
    dp = dof @ vf.transpose(-1, -2)
    fac = 1.0
    if softcap is not None:
        u = torch.tanh(sc * (1.0 / softcap))
        sc = softcap * u
        fac = 1.0 - u * u
    mask = visible(s, causal=causal, window=window, prefix_len=prefix_len)
    m5 = mask if mask.dim() == 2 else mask[:, None, None]
    lse5 = lse.float().view(b, hkv, g, s)[..., None]
    p = torch.where(m5, torch.exp2((sc - lse5) * LOG2E), 0.0)
    ds = torch.where(m5, p * (dp - delta[..., None]) * fac, 0.0)
    p2, ds2 = split(p, split_p), split(ds, split_ds)

    # dQ: each query row sums the key tiles in order
    dq = torch.zeros((b, hkv, g, s, d))
    for k0 in range(0, s, t):
        ks = slice(k0, k0 + t)
        dq = dq + products([x if x is None else x[..., ks] for x in ds2],
                           kf[:, :, :, ks])
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)

    # dK, dV: per key tile, split sp = (head group sg, query part sq)
    # sums its heads, then its query tiles, in order; then the partials
    # in the order of sp
    pre = prefix_len.tolist() if prefix_len is not None and causal \
        else [0] * b
    splits, heads = plan.n_g * plan.n_q, g // plan.n_g
    part_k = torch.zeros((splits, b, hkv, s, d))
    part_v = torch.zeros((splits, b, hkv, s, dv))
    for bi in range(b):
        for f0 in range(0, s, f):
            fs = slice(f0, min(s, f0 + f))
            lo = f0 if causal and f0 >= pre[bi] else 0
            hi = min(s, f0 + f - 1 + window) if window else s
            first, n_all = lo // t, (hi - 1) // t - lo // t + 1
            per = -(-n_all // plan.n_q)
            for sp in range(splits):
                sg, sq = divmod(sp, plan.n_q)
                acc_k = torch.zeros((hkv, fs.stop - f0, d))
                acc_v = torch.zeros((hkv, fs.stop - f0, dv))
                for h in range(sg * heads, (sg + 1) * heads):
                    for qt in range(first + sq * per,
                                    first + min(n_all, (sq + 1) * per)):
                        qs = slice(qt * t, qt * t + t)

                        def w(x):
                            return None if x is None else \
                                x[bi, :, h, qs, fs].transpose(-1, -2)
                        acc_k = acc_k + products([w(x) for x in ds2],
                                                 qf[bi, :, h, qs])
                        acc_v = acc_v + products([w(x) for x in p2],
                                                 dof[bi, :, h, qs])
                part_k[sp, bi, :, fs] = acc_k * scale
                part_v[sp, bi, :, fs] = acc_v
    dk, dvv = part_k[0], part_v[0]
    for sp in range(1, splits):
        dk, dvv = dk + part_k[sp], dvv + part_v[sp]
    return (dq.bfloat16(), dk.permute(0, 2, 1, 3).bfloat16(),
            dvv.permute(0, 2, 1, 3).bfloat16())


def inputs(seed, b, s, hq, hkv, d, dv):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .bfloat16() for shape in ((b, s, hq, d), (b, s, hkv, d),
                                      (b, s, hkv, dv), (b, s, hq, dv))]


CASES = {   # b, s, hq, hkv, d, dv, options
    "gemma2-like": (1, 300, 4, 2, 256, 256,
                    dict(softcap=50.0, window=100)),
    "gemma2-like-global": (2, 200, 4, 2, 256, 256, dict(softcap=50.0)),
    "paligemma-like": (1, 300, 8, 1, 256, 256, dict(prefix=(100,))),
    "hubert-like": (2, 200, 4, 4, 80, 80, dict(causal=False)),
    "mla-like": (1, 200, 4, 4, 192, 128, {}),
    "ragged-d72": (2, 77, 4, 2, 72, 72, dict(softcap=30.0, prefix=(0, 40))),
}


def run_case(name, seed, **controls):
    b, s, hq, hkv, d, dv, opts = CASES[name]
    q, k, v, dout = inputs(seed, b, s, hq, hkv, d, dv)
    kw = dict(opts)
    if "prefix" in kw:
        kw["prefix_len"] = torch.tensor(kw.pop("prefix"), dtype=torch.int32)
    out, lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
    got = kernel_emulation(q, k, v, out, dout, lse, **kw, **controls)
    want = flash_attention_bwd_torch(q, k, v, out, dout, lse, **kw)
    return [gate_ratio(x, w) for x, w in zip(got, want)], got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_rounding_within_the_bf16_gate(name):
    """dq, dk, dv of the emulated kernel within the bf16 gate of the
    plain backward, at shapes whose plans split the dK/dV blocks (so the
    partials' fixed-order sum is emulated too)."""
    ratios, got, want = run_case(name, 3)
    for x, w in zip(got, want):
        assert x.shape == w.shape and x.dtype == w.dtype == torch.bfloat16
    assert max(ratios) <= 1.0, ratios


def test_the_emulated_shapes_split_the_dkdv_blocks():
    """The small shapes run the split and the partials' sum: every case
    splits, paligemma's its 8 q heads and its query range."""
    plans = {n: bwd_plan(*CASES[n][:6]) for n in CASES}
    assert plans["paligemma-like"].n_g == 8
    assert all(p.n_g * p.n_q > 1 for p in plans.values())


@pytest.mark.parametrize("control,shape", [
    ("one bf16 P", "gemma2-like-global"), ("one bf16 dS", "gemma2-like"),
    ("one bf16 P", "hubert-like"), ("one bf16 dS", "hubert-like")])
def test_negative_controls_fail_the_bf16_gate(control, shape):
    """One bf16 P leaves dV several times over the gate; one bf16 dS
    leaves dQ and dK several times over it (at gemma2-like (2, 200, 4/2,
    256), softcap 50, and at hubert-like (2, 200, 4, 80), bidirectional:
    18-53x in the runs that fixed these bounds). So the kernel splits
    both into hi + lo."""
    kw = dict(split_p=False) if control == "one bf16 P" \
        else dict(split_ds=False)
    ratios, _, _ = run_case(shape, 3, **kw)
    sound, _, _ = run_case(shape, 3)
    assert max(sound) <= 1.0
    if control == "one bf16 P":
        assert ratios[2] > 4.0 and max(ratios[:2]) <= 1.0, ratios
    else:
        assert min(ratios[:2]) > 4.0 and ratios[2] <= 1.0, ratios


@pytest.mark.parametrize("causal,softcap,d", [(True, 50.0, 256),
                                              (False, None, 64)])
def test_kernel_rounding_against_the_reference_backward(causal, softcap, d):
    """The emulation against the reference's own backward, ``_flash_bwd``
    (the custom VJP that ``jax.vjp`` of the reference's ``attention``
    runs), in float32 on the same bf16 values and fed the same residuals:
    the reference forward's lse and its output rounded to bf16, as a bf16
    model keeps it. (With the unrounded float32 output ``jax.vjp`` keeps,
    delta differs, and dq and dk by up to 38x the gate at these shapes:
    a property of the bf16 residual, which the plain version shares.)"""
    b, s, hq, hkv, dv = 1, 200, 4, 2, d
    q, k, v, dout = inputs(17, b, s, hq, hkv, d, dv)
    f32 = [jnp.asarray(x.float().numpy()) for x in (q, k, v, dout)]
    scale, kb = d ** -0.5, 64
    pad = ((0, 0), (0, -s % kb), (0, 0), (0, 0))
    kp, vp = jnp.pad(f32[1], pad), jnp.pad(f32[2], pad)
    q_pos = jnp.arange(s)
    out, lse = jax_layers._flash_fwd_impl(f32[0], kp, vp, q_pos, scale,
                                          causal, softcap, kb, (), s)
    out16 = torch.from_numpy(np.array(out)).bfloat16()
    res = (f32[0], kp, vp, q_pos, jnp.asarray(out16.float().numpy()), lse)
    want = jax_layers._flash_bwd(scale, causal, softcap, kb, (), s, (), res,
                                 f32[3])[:3]
    want = [torch.from_numpy(np.array(x)[:, :s]).bfloat16() for x in want]
    tlse = torch.from_numpy(np.array(lse)).reshape(b, hq, s)
    got = kernel_emulation(q, k, v, out16, dout, tlse, causal=causal,
                           softcap=softcap)
    ratios = [gate_ratio(x, w) for x, w in zip(got, want)]
    assert max(ratios) <= 1.0, ratios


PATH_SHAPES = {   # b, s, hq, hkv, d, dv: n_g, n_q, partial bytes
    "gemma2-2b": ((2, 1024, 8, 4, 256, 256), (2, 1, 33_554_432)),
    "paligemma-3b": ((1, 1024, 8, 1, 256, 256), (8, 2, 33_554_432)),
    "hubert-xlarge": ((2, 1000, 16, 16, 80, 80), (1, 1, 0)),
    "mla": ((1, 1024, 16, 16, 192, 128), (1, 1, 0)),
}


@pytest.mark.parametrize("name", sorted(PATH_SHAPES))
def test_launch_plan_fills_the_card(name):
    """At the training paths' shapes (and the MLA row) the dK/dV launch
    has at least the blocks the card holds at once (two an SM), the dQ
    launch a block for every SM, and the split and its float32 partials
    are as PERF.md states them."""
    shape, (n_g, n_q, partial) = PATH_SHAPES[name]
    plan = bwd_plan(*shape)
    assert (plan.n_g, plan.n_q, plan.partial_bytes) == (n_g, n_q, partial)
    assert plan.kv_blocks >= 2 * SMS and plan.q_blocks >= SMS
    b, s, hq, hkv, d, dv = shape
    assert plan.partial_bytes == (0 if n_g * n_q == 1 else
                                  4 * n_g * n_q * b * s * hkv * (d + dv))


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_two_blocks_fit_an_sm_at_every_head_dim(d):
    """The shared memory of both launches lets two blocks share an SM at
    every bf16 head dim the kernel takes (the 232,448-byte block limit
    and the SM's 233,472 bytes, 1,024 kept per block)."""
    for dv in (d, 128):
        for kv in (True, False):
            need = bwd_shared_bytes(d, dv, kv)
            assert 2 * (need + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES
