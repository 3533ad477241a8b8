"""Attention over a chunk of the queries: ``q_offset`` and Sk != Sq in
the plain ``flash_attention`` / ``flash_attention_bwd`` (what the CUDA
kernels compute on the card), held to the reference.

Each case cuts a sequence of Sk keys into 4 query chunks of Sk / 4 rows
at offsets 0, Sk / 4, ... and holds the second and the last chunk, in
float32, to the reference's ``attention(q_offset=)`` and to ``jax.grad``
of it (rtol 1e-4, atol 1e-5, the tolerance ``tests/test_torch_train.py``
holds the whole-sequence backward to; offset 0 is the whole-sequence
path those tests hold). The windowed case's reduced window (16)
crosses the chunk bounds. The chunks joined give the whole-sequence
result: outputs, lse and dq row for row, dk and dv summed over the
chunks, within rtol 1e-5 / atol 1e-6 (the same float32 sums taken over
other shapes). The guards refuse an offset that is not a host int or
does not fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import attention

RTOL, ATOL = 1e-4, 1e-5          # the reference's scan against the plain
JOIN_RTOL, JOIN_ATOL = 1e-5, 1e-6
CHUNKS = 4

CASES = {   # b, sk, hq, hkv, d, causal, window, softcap, prefix, q scale
    "causal": (2, 64, 4, 2, 16, True, None, None, None, 1.0),
    "windowed": (2, 64, 4, 2, 16, True, 16, None, None, 1.0),
    "prefix": (2, 64, 4, 1, 16, True, None, None, (9, 40), 1.0),
    "softcap": (2, 64, 4, 2, 16, True, None, 5.0, None, 4.0),
    "bidirectional": (2, 64, 4, 4, 16, False, None, None, None, 1.0),
}


def inputs(case, seed=0):
    b, sk, hq, hkv, d, causal, window, softcap, prefix, qs = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sk, hq, d)) * qs).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, sk, hq, d)).astype(np.float32)
    pre = None if prefix is None else np.array(prefix, np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    return (q, k, v, dout, pre), kw, d ** -0.5


def reference(q, k, v, dout, pre, kw, scale, off):
    """The reference's ``attention(q_offset=off)`` of the chunk q and its
    ``jax.grad`` against the cotangent ``dout``."""
    def f(q, k, v):
        return jax_layers.attention(
            q, k, v, causal=kw["causal"], window=kw["window"], scale=scale,
            attn_softcap=kw["softcap"], q_offset=off,
            prefix_len=None if pre is None else jnp.asarray(pre))
    args = tuple(map(jnp.asarray, (q, k, v)))
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * dout),
                     argnums=(0, 1, 2))(*args)
    return out, grads


def chunks(case):
    """Per chunk: (offset, the chunk's tensors q, dout, the shared k, v,
    prefix) and the case's options."""
    (q, k, v, dout, pre), kw, scale = inputs(case)
    n = q.shape[1] // CHUNKS
    out = []
    for c in range(CHUNKS):
        rows = slice(c * n, (c + 1) * n)
        out.append((c * n, np.ascontiguousarray(q[:, rows]),
                    np.ascontiguousarray(dout[:, rows])))
    return out, (q, k, v, dout, pre), kw, scale


@pytest.mark.parametrize("case", sorted(CASES))
def test_offset_chunks_match_the_reference(case):
    """The second and the last chunk's output (``ops.flash_attention``
    with ``q_offset``), its plain backward fed that output and lse, and
    ``layers.attention`` under autograd, against the reference's
    ``attention(q_offset=)`` and ``jax.grad`` of it."""
    parts, (_, k, v, _, pre), kw, scale = chunks(case)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tpre = None if pre is None else torch.from_numpy(pre)
    for off, q, dout in (parts[1], parts[-1]):
        want, (wq, wk, wv) = reference(q, k, v, dout, pre, kw, scale, off)
        tq, tdo = torch.from_numpy(q), torch.from_numpy(dout)
        out, lse = ops.flash_attention(tq, tk, tv, scale=scale,
                                       prefix_len=tpre, return_lse=True,
                                       q_offset=off, **kw)
        assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{case} out @{off}")
        dq, dk, dv = ops.flash_attention_bwd(tq, tk, tv, out, tdo, lse,
                                             scale=scale, prefix_len=tpre,
                                             q_offset=off, **kw)
        assert dq.shape == tq.shape and dk.shape == tk.shape \
            and dv.shape == tv.shape
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
        got = attention(qg, kg, vg, causal=kw["causal"], window=kw["window"],
                        scale=scale, attn_softcap=kw["softcap"],
                        prefix_len=tpre, q_offset=off)
        torch.testing.assert_close(got.detach(), out, rtol=0, atol=0)
        (got * tdo).sum().backward()
        for name, w, p, a in zip("qkv", (wq, wk, wv), (dq, dk, dv),
                                 (qg.grad, kg.grad, vg.grad)):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{case} plain d{name} @{off}")
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{case} autograd d{name} "
                                               f"@{off}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_offset_chunks_join_to_the_whole_sequence(case):
    """The chunks' outputs, lse and dq joined row for row, and their dk
    and dv summed, equal the whole sequence's; under a causal mask the
    keys past a chunk's last position get dk = dv = 0."""
    parts, (q, k, v, dout, pre), kw, scale = chunks(case)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    tpre = None if pre is None else torch.from_numpy(pre)
    opts = dict(scale=scale, prefix_len=tpre, **kw)
    out, lse = ops.flash_attention(*t[:3], return_lse=True, **opts)
    dq, dk, dv = ops.flash_attention_bwd(*t[:3], out, t[3], lse, **opts)
    outs, lses, dqs = [], [], []
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for off, qc, dc in parts:
        tq, tdo = torch.from_numpy(qc), torch.from_numpy(dc)
        o, l_ = ops.flash_attention(tq, t[1], t[2], return_lse=True,
                                    q_offset=off, **opts)
        g = ops.flash_attention_bwd(tq, t[1], t[2], o, tdo, l_,
                                    q_offset=off, **opts)
        outs.append(o)
        lses.append(l_)
        dqs.append(g[0])
        dk_sum += g[1]
        dv_sum += g[2]
        last = off + qc.shape[1]
        if kw["causal"] and pre is None and last < k.shape[1]:
            assert not g[1][:, last:].any() and not g[2][:, last:].any(), \
                f"{case}: keys no row of the chunk @{off} sees got a gradient"
    for name, got, want in (("out", torch.cat(outs, 1), out),
                            ("lse", torch.cat(lses, 2), lse),
                            ("dq", torch.cat(dqs, 1), dq),
                            ("dk", dk_sum, dk), ("dv", dv_sum, dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=JOIN_RTOL, atol=JOIN_ATOL,
                                   err_msg=f"{case} {name}")


def test_offset_is_guarded():
    """An offset that is not a host int, is negative, or leaves a query
    row without its key, raises in both entry points; ``visible`` and
    ``bwd_plan`` take Sk."""
    (q, k, v, dout, _), kw, _ = inputs("causal")
    tq, tk, tv, tdo = (torch.from_numpy(np.ascontiguousarray(a))
                       for a in (q[:, :16], k, v, dout[:, :16]))
    out, lse = ops.flash_attention(tq, tk, tv, return_lse=True, q_offset=48)
    for bad, err in ((torch.tensor(16), TypeError), (True, TypeError),
                     (-1, ValueError), (49, ValueError)):
        with pytest.raises(err, match="q_offset"):
            ops.flash_attention(tq, tk, tv, q_offset=bad)
        with pytest.raises(err, match="q_offset"):
            ops.flash_attention_bwd(tq, tk, tv, out, tdo, lse, q_offset=bad)
    with pytest.raises(ValueError, match="flash_attention.v"):
        ops.flash_attention(tq, tk, tv[:, :32], q_offset=0)
    mask = fa.visible(16, causal=True, window=8, sk=64, q_offset=48)
    i = 48 + torch.arange(16)[:, None]
    j = torch.arange(64)[None, :]
    assert torch.equal(mask, (j <= i) & (i - j < 8))
    assert fa.bwd_plan(2, 256, 8, 4, 256, 256, 1024) \
        == fa.bwd_plan(2, 256, 8, 4, 256, 256, 1024)
    plan = fa.bwd_plan(2, 256, 8, 4, 256, 256, 1024)
    assert plan.q_blocks == 256 // 32 * 8 * 2
    assert plan.kv_blocks == 1024 // 32 * 4 * 2 * plan.n_g * plan.n_q
    assert ops.flash_attention.launches == 0      # CPU: the plain version
