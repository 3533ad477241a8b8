"""Row RMSNorm: the CUDA kernel's launcher and its plain PyTorch version.

    out = cast(x * rsqrt(mean(x^2, -1) + eps) * w'),
    w' = 1 + f32(w) when ``zero_centered`` (gemma), else f32(w)

``x`` (..., d) float32 or bfloat16, ``w`` (d,) float32 or bfloat16; the
result has x's shape and type. Everything between the loads and the
final cast is float32, as in the TPU kernel: note that this differs from
the reference model's ``layers.rms_norm``, which adds ``1 + w`` in the
weight's type, so the port's model passes ``(1 + w).to(w.dtype)`` with
``zero_centered=False`` (see :func:`repro_torch.models.layers.rms_norm`).
The CUDA kernel lives in ``csrc/rmsnorm.cu``;
:func:`repro_torch.kernels.ops.rmsnorm` is the guarded entry point that
picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_torch(x, w, *, eps: float = 1e-6,
                  zero_centered: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the kernel's expressions, on whatever
    device the inputs lie on."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    wf = w.float()
    if zero_centered:
        wf = 1.0 + wf
    return ((xf * torch.rsqrt(var + eps)) * wf).to(x.dtype)


def row_threads(d: int, dtype: torch.dtype) -> int:
    """Threads per row the kernel's vector path gives a row of ``d``
    elements of ``dtype`` with aligned pointers; 0 where only its scalar
    path can take the row (from the library)."""
    return _launcher()[2](d, DTYPE_CODES[dtype])


@functools.cache
def _launcher():
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.rmsnorm_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    threads = lib.rmsnorm_row_threads
    threads.argtypes = [ctypes.c_int, ctypes.c_int]
    threads.restype = ctypes.c_int
    return fn, err_str, threads


def rmsnorm_cuda(x, w, *, eps: float = 1e-6,
                 zero_centered: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes, types, contiguity and that
    the tensor is not empty; a launch the card refuses raises here."""
    fn, err_str, _ = _launcher()
    d = x.shape[-1]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d,
                 d, eps, int(zero_centered), DTYPE_CODES[x.dtype],
                 DTYPE_CODES[w.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
