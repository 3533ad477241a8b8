"""One new query token against a KV cache: the CUDA kernel's launcher
and its plain PyTorch version.

``q`` (B, Hq, D), ``k_cache`` (B, T, Hkv, D), ``v_cache`` (B, T, Hkv, Dv),
all float32 or all bfloat16, ``pos`` (B,) int32, the absolute position
of the token just inserted; the result is (B, Hq, Dv) in q's type. Slot
``t`` is valid iff ``t < pos + 1`` (a linear cache, so ``pos < T``) or
``t < min(pos + 1, T)`` (``ring``: a sliding-window ring buffer; slot
order does not matter because RoPE was applied at insert). The scaled
scores are softcapped, masked with -2e38 and turned into probabilities
in float32. The CUDA kernel (``csrc/flash_decode.cu``) splits the cache
into slices of ``SLICE`` slots and combines them in a second pass;
:func:`repro_torch.kernels.ops.flash_decode` is the guarded entry point
that picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256                  # the kernel keeps a K row in registers
SLICE = 64                          # cache slots per pass-1 block
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def valid_slots(pos: torch.Tensor, t: int, ring: bool) -> torch.Tensor:
    """(B, T) bool: the cache slots that hold a token."""
    limit = (pos.clamp_max(t - 1) if ring else pos) + 1
    return torch.arange(t, device=pos.device)[None, :] < limit[:, None]


def flash_decode_torch(q, k_cache, v_cache, pos, *,
                       scale: float | None = None,
                       softcap: float | None = None,
                       ring: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one softmax over the whole cache in
    float32, invalid slots given probability 0."""
    b, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).view(b, hkv, hq // hkv, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    valid = valid_slots(pos, t, ring)[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.where(valid,
                    torch.exp(scores - scores.amax(dim=-1, keepdim=True)),
                    0.0)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, dv).to(q.dtype)


@functools.cache
def _launcher():
    lib = build.load("flash_decode")
    fn = lib.flash_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.flash_decode_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    if lib.flash_decode_slice() != SLICE:
        raise RuntimeError("flash_decode: the library's slice length "
                           f"{lib.flash_decode_slice()} != {SLICE}")
    return fn, err_str


def flash_decode_cuda(q, k_cache, v_cache, pos, *,
                      scale: float | None = None,
                      softcap: float | None = None,
                      ring: bool = False) -> torch.Tensor:
    """Launch both passes on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes (D at most
    ``MAX_HEAD_DIM``), types, contiguity, the range of ``pos`` and that
    nothing is empty."""
    fn, err_str = _launcher()
    b, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = hq // hkv
    n_splits = -(-t // SLICE)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((b * hkv, n_splits, g, dv), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                 part_ml.data_ptr(), b, t, hq, hkv, d, dv, scale,
                 0.0 if softcap is None else softcap, int(ring),
                 DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
