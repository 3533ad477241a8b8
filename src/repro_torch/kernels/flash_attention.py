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
multiple of its 512-row blocks). The CUDA kernel lives in
``csrc/flash_attention.cu``; :func:`repro_torch.kernels.ops.flash_attention`
is the guarded entry point that picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256                  # the kernel's accumulator size
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
def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.flash_attention_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: float | None = None,
                         window: int | None = None,
                         softcap: float | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes (head dims at most
    ``MAX_HEAD_DIM``), types, contiguity and that nothing is empty."""
    fn, err_str = _launcher()
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, s, hq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, hq, hkv, d, dv, scale, int(causal),
                 0 if window is None else window,
                 0.0 if softcap is None else softcap, DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    return out
