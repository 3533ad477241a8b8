"""Row RMSNorm: the CUDA kernel's launcher and its plain PyTorch version.

    out = cast(x * rsqrt(mean(x^2, -1) + eps) * w'),
    w' = 1 + f32(w) when ``zero_centered`` (gemma), else f32(w)

``x`` (..., d) float32 or bfloat16, ``w`` (d,) float32 or bfloat16; the
result has x's shape and type. Everything between the loads and the
final cast is float32, as in the TPU kernel: note that this differs from
the reference model's ``layers.rms_norm``, which adds ``1 + w`` in the
weight's type, so the port's model passes ``(1 + w).to(w.dtype)`` with
``zero_centered=False`` (see :func:`repro_torch.models.layers.rms_norm`).
The backward,

    dx = (w' dy - x^ mean(x^ w' dy)) r,  dw = sum over rows of dy x^,

with ``x^ = x r`` and ``r = rsqrt(mean(x^2) + eps)``, is what the
reference gets from autodiff of ``layers.rms_norm``; float32 between the
loads and the casts, dx in x's type and dw in w's. The CUDA kernels live
in ``csrc/rmsnorm.cu`` (the backward's row pass lays rows out as the
forward does, threads per row by width; :func:`bwd_plan` gives its
plan); :func:`repro_torch.kernels.ops.rmsnorm` and
:func:`repro_torch.kernels.ops.rmsnorm_bwd` are the guarded entry points
that pick between the plain versions and the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BWD_WIDTH = 56_000          # the backward's column sums in shared memory


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


def rmsnorm_bwd_torch(x, w, dy, *, eps: float = 1e-6,
                      zero_centered: bool = True):
    """Plain PyTorch version of the backward: (dx, dw)."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    wf = w.float()
    if zero_centered:
        wf = 1.0 + wf
    xh = xf * r
    gw = dy.float() * wf
    dx = (gw - xh * (xh * gw).mean(dim=-1, keepdim=True)) * r
    dw = (dy.float() * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def row_threads(d: int, dtype: torch.dtype) -> int:
    """Threads per row the kernel's vector path gives a row of ``d``
    elements of ``dtype`` with aligned pointers; 0 where only its scalar
    path can take the row (from the library)."""
    return _launcher()[2](d, DTYPE_CODES[dtype])


def bwd_plan(rows: int, d: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
             aligned: bool = True) -> tuple[int, int]:
    """(threads per row, blocks) of the backward's row pass for ``rows``
    rows of ``d`` (from the library, on the current device): threads
    per row 0 is the scalar path; the blocks are the partial rows of dw
    that the column pass sums."""
    lib = _launcher()
    threads = lib[5](d, DTYPE_CODES[x_dtype]) if aligned else 0
    return threads, lib[4](rows, d, DTYPE_CODES[x_dtype],
                           DTYPE_CODES[w_dtype], int(aligned))


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
    bwd = lib.rmsnorm_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    blocks = lib.rmsnorm_bwd_blocks
    blocks.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
    blocks.restype = ctypes.c_int
    bwd_threads = lib.rmsnorm_bwd_row_threads
    bwd_threads.argtypes = [ctypes.c_int, ctypes.c_int]
    bwd_threads.restype = ctypes.c_int
    return fn, err_str, threads, bwd, blocks, bwd_threads


def rmsnorm_cuda(x, w, *, eps: float = 1e-6,
                 zero_centered: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes, types, contiguity and that
    the tensor is not empty; a launch the card refuses raises here."""
    fn, err_str = _launcher()[:2]
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


def rmsnorm_bwd_cuda(x, w, dy, *, eps: float = 1e-6,
                     zero_centered: bool = True):
    """Launch the backward (per-row dx with per-block dw partials, then
    their column sums) on the current stream of the inputs' device;
    returns (dx, dw). Unguarded: the caller has checked shapes, types
    (dy in x's type), contiguity, the width (:data:`MAX_BWD_WIDTH`) and
    that nothing is empty."""
    err_str, bwd = _launcher()[1], _launcher()[3]
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    with torch.cuda.device(x.device):
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
        parts = bwd_plan(rows, d, x.dtype, w.dtype, aligned)[1]
        partials = torch.empty((parts, d), dtype=torch.float32,
                               device=x.device)
        err = bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), partials.data_ptr(), parts, rows, d, eps,
                  int(zero_centered), DTYPE_CODES[x.dtype],
                  DTYPE_CODES[w.dtype],
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return dx, dw
