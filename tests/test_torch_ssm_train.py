"""The backward of the port's Mamba-2 SSD scan on the CPU, held against
the JAX package.

``ssd_scan_bwd_torch`` (the plain version of the ``ssd_scan_bwd``
kernel) against ``jax.vjp`` of the reference's ``ssd_chunked`` in
float32 and against ``torch.autograd`` of the port's own
``ssd_scan_torch`` in float64; the guards of ``ops.ssd_scan_bwd``; the
``SSDScanFn`` autograd Function against the plain backward; and the
bf16 kernel's rounding emulated on the CPU (every product with its
float32 operand split into bf16 hi + lo, float32 sums) within the
card's gate of the plain version, where one plain bf16 operand fails
it. Inputs are drawn with NumPy from a seed, A in -[1, 16] and dt
log-uniform in [1e-3, 1e-1] (Mamba-2's init), so the state carried
across chunks shows. The CUDA kernel runs only on the card
(``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.layers import ssd_scan as ssd_scan_fn

from test_torch_ssm import scan_inputs, torch_args

GRAD_REL = 1e-4     # float32 against jax.vjp: of each gradient's largest
F64_REL = 1e-10     # float64 against autograd: the same formulas, reordered

# name -> (b, s, h, p, g, n, chunk, with dfinal)
CASES = {
    "ragged-g2-of-4-dfinal": (2, 37, 4, 8, 2, 16, 8, True),
    "whole-chunks": (1, 64, 2, 16, 1, 32, 16, False),
    "one-ragged-chunk": (1, 5, 2, 4, 1, 4, 8, True),
    "g-equals-h-dfinal": (2, 40, 4, 8, 4, 8, 16, True),
    "rep8-ragged-dfinal": (1, 40, 8, 8, 1, 16, 16, True),
}
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def bwd_inputs(case, seed=0):
    """(x, dt, A, B, C) as NumPy float32, dy and dfinal (or None)."""
    b, s, h, p, g, n, chunk, with_final = CASES[case]
    arrays = scan_inputs(seed, b, s, h, p, g, n)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_final else None
    return arrays, dy, dfinal, chunk


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_reference_vjp(case):
    """Every gradient within 1e-4 of its largest of ``jax.vjp`` of the
    reference's ``ssd_chunked`` (the function the reference's training
    step differentiates), with the cotangent of the final state zero
    where ``dfinal`` is None."""
    arrays, dy, dfinal, chunk = bwd_inputs(case)
    b, s, h, p, g, n = CASES[case][:6]
    (_, _), vjp = jax.vjp(
        lambda *a: jax_ssm.ssd_chunked(*a, chunk),
        *(jnp.asarray(a) for a in arrays))
    cot_final = np.zeros((b, h, p, n), np.float32) if dfinal is None \
        else dfinal
    want = vjp((jnp.asarray(dy), jnp.asarray(cot_final)))
    got = ssd.ssd_scan_bwd_torch(
        *torch_args(arrays), torch.from_numpy(dy),
        None if dfinal is None else torch.from_numpy(dfinal), chunk)
    for name, gt, wt in zip(NAMES, got, want):
        assert gt.dtype == torch.float32, name
        err = rel_err(gt.numpy(), wt)
        assert err <= GRAD_REL, f"{name}: {err:.3e} of the largest"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_float64_autograd(case):
    """In float64 the explicit formulas equal ``torch.autograd`` of the
    plain forward within 1e-10 of each gradient's largest."""
    arrays, dy, dfinal, chunk = bwd_inputs(case, seed=3)
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
              for a in arrays]
    y, final = ssd.ssd_scan_torch(*leaves, chunk)
    dy64 = torch.from_numpy(dy).double()
    outs, cots = (y,), (dy64,)
    if dfinal is not None:
        outs, cots = (y, final), (dy64, torch.from_numpy(dfinal).double())
    want = torch.autograd.grad(outs, leaves, cots)
    got = ssd.ssd_scan_bwd_torch(
        *(t.detach() for t in leaves), dy64,
        None if dfinal is None else cots[1], chunk)
    for name, gt, wt in zip(NAMES, got, want):
        assert gt.dtype == torch.float64, name
        assert rel_err(gt.numpy(), wt.numpy()) <= F64_REL, name


def test_ssd_scan_bwd_entry_point_guards():
    arrays, dy, dfinal, chunk = bwd_inputs("ragged-g2-of-4-dfinal")
    x, dt, A, B, C = torch_args(arrays)
    dy, dfinal = torch.from_numpy(dy), torch.from_numpy(dfinal)
    before = ops.ssd_scan_bwd.launches
    bad = [
        (TypeError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy.bfloat16())),
        (TypeError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy,
                                             dfinal.double())),
        (TypeError, lambda: ops.ssd_scan_bwd(x, dt.bfloat16(), A, B, C, dy)),
        (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C,
                                              dy[:, :5].contiguous())),
        (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy,
                                              dfinal[..., :3].contiguous())),
        (ValueError, lambda: ops.ssd_scan_bwd(
            x, dt, A, B, C, dy.transpose(1, 2).contiguous().transpose(1, 2))),
        (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C,
                                              dy.to("meta"))),
        (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B[:, :, :1]
                                              .contiguous(), C, dy)),
        (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy, None, 0)),
        (TypeError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy.numpy())),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    got = ops.ssd_scan_bwd(x, dt, A, B, C, dy, dfinal, chunk)
    want = ssd.ssd_scan_bwd_torch(x, dt, A, B, C, dy, dfinal, chunk)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)
    assert ops.ssd_scan_bwd.launches == before   # the CPU never launches


@pytest.mark.parametrize("use_final", [False, True])
def test_scan_function_backward_is_the_plain_bwd(use_final):
    """``SSDScanFn`` (``models.layers.ssd_scan``) hands autograd the plain
    backward's gradients, with the final state's cotangent when the
    final state is used (and None, not zeros, when it is not)."""
    arrays, dy, dfinal, chunk = bwd_inputs("ragged-g2-of-4-dfinal", seed=5)
    leaves = [t.requires_grad_(True) for t in torch_args(arrays)]
    y, final = ssd_scan_fn(*leaves, chunk)
    dy, dfinal = torch.from_numpy(dy), torch.from_numpy(dfinal)
    loss = (y * dy).sum() + ((final * dfinal).sum() if use_final else 0.0)
    grads = torch.autograd.grad(loss, leaves)
    want = ssd.ssd_scan_bwd_torch(*(t.detach() for t in leaves), dy,
                                  dfinal if use_final else None, chunk)
    for name, gt, wt in zip(NAMES, grads, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------------
# the bf16 kernel's rounding, emulated
# ---------------------------------------------------------------------------

def bf16(t):
    return t.bfloat16().float()


def split_mm(a, b):
    """A product as the bf16 kernel takes it: each float32 operand split
    into bf16 hi + lo (lo = 0 for an operand that is bf16 already), the
    three products hi hi, lo hi, hi lo exact, summed in float32."""
    ah, bh = bf16(a), bf16(b)
    al, bl = bf16(a - ah), bf16(b - bh)
    return ah @ bh + al @ bh + ah @ bl


def one_bf16_mm(a, b):
    """The fault the split avoids: each operand rounded once to bf16."""
    return bf16(a) @ bf16(b)


def gate_ratio(got, want):
    """The largest error over the card's gate of the plain version: two
    bf16 ulps of max(|want|, max|want| / 256) for a bf16 output, 1e-5 of
    |want| plus 1e-5 of max|want| for a float32 one (chip_smoke.py's
    ``close_to_plain``)."""
    g, w = got.double(), want.double()
    amax = float(w.abs().max())
    if want.dtype == torch.float32:
        bound = 1e-5 * w.abs() + 1e-5 * amax
    else:
        mag = w.abs().clamp(min=max(amax / 256, 2.0 ** -126))
        bound = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / bound).max())


@pytest.mark.parametrize("shape", [(1, 512, 4, 64, 1, 128, 256),
                                   (1, 700, 4, 64, 1, 64, 256)])
def test_bf16_split_products_stay_within_the_gate(shape):
    """At mamba2's (P 64, N 128, chunk 256) and zamba2's (N 64, a ragged
    chunk) head shapes, bf16 inputs: the kernel's split products keep
    every gradient within the gate (at most half of it here), where one
    bf16 operand per product misses it for every output (the decays and
    dM's products: 19-220x when this test was written)."""
    b, s, h, p, g, n, chunk = shape
    args = torch_args(scan_inputs(0, b, s, h, p, g, n,
                                  dtype=jnp.bfloat16))
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, s, h, p)).astype(np.float32)).bfloat16()
    want = ssd.ssd_scan_bwd_torch(*args, dy, None, chunk)
    split = ssd.ssd_scan_bwd_torch(*args, dy, None, chunk, mm=split_mm)
    plain = ssd.ssd_scan_bwd_torch(*args, dy, None, chunk, mm=one_bf16_mm)
    for name, gs, gp, wt in zip(NAMES, split, plain, want):
        assert gs.dtype == wt.dtype
        assert gate_ratio(gs, wt) <= 0.75, name
        assert gate_ratio(gp, wt) > 4.0, name
