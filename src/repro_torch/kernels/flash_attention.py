"""Forward attention with an online softmax: the CUDA kernel's launcher
and its plain PyTorch version.

``q`` (B, S, Hq, D), ``k`` (B, S, Hkv, D), ``v`` (B, S, Hkv, Dv), all
float32 or all bfloat16; the result is (B, S, Hq, Dv) in q's type. GQA:
q head ``h`` attends kv head ``h // (Hq // Hkv)``. Key ``j`` is visible
from query ``i`` iff ``j <= i`` when ``causal`` and ``i - j < window``
when a window is set (the last ``window`` keys including the query
itself, the HF convention of the reference). The softcap
``cap * tanh(s / cap)`` is applied to the scaled scores before the mask.
Scores and sums are float32; any S is accepted (the TPU kernel wanted a
multiple of its 512-row blocks).

``csrc/flash_attention.cu`` holds two CUDA kernels, chosen by dtype:
bfloat16 launches the tensor-core kernel (wgmma products, TMA loads,
warp-specialised; its loads need head dims that are multiples of 8 and
16-byte aligned tensors, see :func:`refusal`), float32 the SIMT kernel,
whose float32 FMAs keep float32's tolerance.
:func:`repro_torch.kernels.ops.flash_attention` is the guarded entry point
that picks between the plain version and the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256                  # the kernels' accumulator size
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def visible(s: int, *, causal: bool, window: int | None,
            device=None) -> torch.Tensor:
    """(S, S) bool: key ``j`` (column) visible from query ``i`` (row)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= i - j < window
    return mask


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: the whole (S, S) score matrix in float32,
    masked probabilities set to 0, on whatever device the inputs lie on."""
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).view(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = visible(s, causal=causal, window=window, device=q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)             # (B, S, Hkv, G)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, s, hq, dv).to(q.dtype)


@functools.cache
def _library():
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_fits.argtypes = [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.flash_attention_fits.restype = ctypes.c_int
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def refusal(q, k, v) -> str | None:
    """Why the CUDA kernel of these tensors' dtype cannot take them (the
    rule as the library states it), or None. The bfloat16 tensor-core
    kernel reads q, k and v through TMA tensor maps, whose row strides and
    base addresses must be multiples of 16 bytes: head dims that are
    multiples of 8 and 16-byte aligned data. The float32 SIMT kernel takes
    any head dim up to the library's maximum."""
    lib = _library()
    d, dv = q.shape[-1], v.shape[-1]
    why = lib.flash_attention_fits(d, dv, q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), DTYPE_CODES[q.dtype])
    if why == 1:
        return (f"head dims ({d}, {dv}) exceed the kernel's "
                f"{lib.flash_attention_max_head_dim()}")
    if why == 2:
        return (f"head dims ({d}, {dv}) are not multiples of 8, which the "
                f"bfloat16 kernel's TMA loads need")
    if why == 3:
        off = [n for n, x in (("q", q), ("k", k), ("v", v))
               if x.data_ptr() % 16]
        return (f"{', '.join(off)} not 16-byte aligned, which the bfloat16 "
                f"kernel's TMA loads need")
    return None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: float | None = None,
                         window: int | None = None,
                         softcap: float | None = None) -> torch.Tensor:
    """Launch the kernel of the inputs' dtype (bfloat16: tensor cores;
    float32: SIMT) on the current stream of their device. Unguarded: the
    caller has checked shapes (head dims at most ``MAX_HEAD_DIM``),
    types, contiguity, :func:`refusal` and that nothing is empty."""
    lib = _library()
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, s, hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, d, dv, scale, int(causal),
            0 if window is None else window,
            0.0 if softcap is None else softcap, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({what})")
    return out
