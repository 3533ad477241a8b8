"""The bfloat16 ``flash_attention`` kernel's arithmetic, emulated in plain
PyTorch on the CPU and held to the gate the card holds the kernel to.

The tensor-core kernel (``csrc/flash_attention.cu``) runs only on the
card, but where it rounds can be emulated on the CPU: bf16 q and k
multiplied into float32 scores, the scale applied to those float32
scores (in log2 units), the softcap in the kernel's exp form, the mask,
p taken against a running max over 64-key tiles, P split into bf16
``hi`` and ``lo`` for the two products with V, and the row sum over the
unrounded p. :func:`kernel_emulation` does exactly that, and the tests
hold it within the bf16 gate of
``tests/test_torch_cuda.py::assert_close_to_plain`` (2 bf16 ulps of
max(|want|, max|want| / 256)) of the port's plain version,
``flash_attention_torch``, at small gemma2- and zamba2-like shapes.

Two negative controls record why the kernel is built as it is: one bf16
P (what FlashAttention-2 and -3 feed the PV product), and q * scale
rounded to bf16 before the product (a pre-scaled tensor-core operand),
each fail that gate at a stated shape.

Inputs are drawn with NumPy from a seed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_torch,
                                                 visible)

KV_TILE = 64                        # keys per tile of the kernel
LOG2E = 1.4426950408889634


def gate_ratio(got, want):
    """Largest error over the bf16 gate's bound (<= 1 passes): 2 bf16
    ulps of max(|want|, max|want| / 256)."""
    g, w = got.double(), want.double()
    amax = float(w.abs().max())
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    bound = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / bound).max())


def kernel_emulation(q, k, v, *, causal=True, window=None, softcap=None,
                     split_p=True, prescale_q=False):
    """The tensor-core kernel's rounding on bf16 (B, S, H, D) inputs:
    float32 scores of the bf16 operands, scaled after the product into
    log2 units, softcapped as ``cap - 2 cap / (exp(2 s / cap) + 1)``,
    masked; an online softmax in powers of 2 over 64-key tiles; P as bf16
    hi + lo (``split_p``) or as one bf16 (the first negative control);
    q * scale rounded to bf16 before the product where ``prescale_q``
    (the second). Returns (B, S, Hq, Dv) bf16."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5
    qf = (q.float() * scale).bfloat16().float() if prescale_q else q.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (qf, kf, vf))
    acc = qf @ kf.transpose(-1, -2)
    after = 1.0 if prescale_q else scale        # the scale left to apply
    if softcap is not None:
        cap2 = softcap * LOG2E
        s2 = cap2 - 2.0 * cap2 / (torch.exp2(acc * (2.0 * LOG2E * after
                                                    / softcap)) + 1.0)
    else:
        s2 = acc * (after * LOG2E)
    mask = visible(s, causal=causal, window=window)
    s2 = s2.masked_fill(~mask, float("-inf"))
    m = torch.full((b, hq, s, 1), float("-inf"))
    l = torch.zeros((b, hq, s, 1))
    o = torch.zeros((b, hq, s, dv))
    for j0 in range(0, s, KV_TILE):
        st = s2[..., j0:j0 + KV_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(st - base)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        vt = vf[..., j0:j0 + KV_TILE, :]
        o = o * corr + hi @ vt
        if split_p:
            o = o + (p - hi).bfloat16().float() @ vt
        m = m_new
    out = o * (1.0 / l.clamp_min(1e-30))
    return out.permute(0, 2, 1, 3).bfloat16()


def inputs(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                 dtype=np.float32))
            .bfloat16() for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 400])
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
@pytest.mark.parametrize("d", [256, 224])
def test_kernel_rounding_within_the_bf16_gate(d, hq, hkv, softcap, window,
                                              s):
    q, k, v = inputs(s * 7 + d, 1, s, hq, hkv, d)
    got = kernel_emulation(q, k, v, window=window, softcap=softcap)
    want = flash_attention_torch(q, k, v, window=window, softcap=softcap)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert gate_ratio(got, want) <= 0.5


@pytest.mark.parametrize("case", ["one bf16 P", "q * scale rounded"])
def test_negative_controls_fail_the_bf16_gate(case):
    """One bf16 P at (1, 1024, 2, 256) with softcap 50 and window 300;
    q * scale rounded to bf16 at zamba2's head dim, (1, 700, 2, 224),
    without softcap or window. Each is several times over the gate, so
    the kernel splits P and scales the float32 scores."""
    if case == "one bf16 P":
        q, k, v = inputs(11, 1, 1024, 2, 2, 256)
        kw = dict(window=300, softcap=50.0)
        got = kernel_emulation(q, k, v, split_p=False, **kw)
    else:
        q, k, v = inputs(12, 1, 700, 2, 2, 224)
        kw = {}
        got = kernel_emulation(q, k, v, prescale_q=True, **kw)
    want = flash_attention_torch(q, k, v, **kw)
    sound = kernel_emulation(q, k, v, **kw)
    assert gate_ratio(sound, want) <= 0.5
    assert gate_ratio(got, want) > 4.0
