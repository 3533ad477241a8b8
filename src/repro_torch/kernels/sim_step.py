"""Sparse population max-plus relaxation: the CUDA kernel's launcher and
its plain PyTorch version.

``n_steps`` synchronous (Jacobi) sweeps, from all-zero ends, of

    end[b, s] = duration[b, s]
              + max(release[b, s],
                    max(max_p((end[b, pred[b, s, p]] + lat[b, s, p])
                              + volbw[b, s, p]), 0))

over the padded gather form: ``pred`` (B, S, P+1) int32 sources with the
sentinel ``S`` (an always-zero slot), ``lat``/``volbw`` (B, S, P+1)
float32 per-edge lags with ``-inf`` pads, ``duration``/``release`` (B, S)
float32. Returns (B, S) float32 finish times. The CUDA kernel lives in
``csrc/sim_relax_pop.cu``; :func:`repro_torch.kernels.ops.sim_relax_pop`
is the guarded entry point that picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_SHARED_BYTES = 232_448          # dynamic shared memory one block may use


def shared_bytes(s: int) -> int:
    """Shared memory of one block: the double-buffered (S+1)-slot ends."""
    return 2 * (s + 1) * 4


def sim_relax_pop_torch(pred, lat, volbw, duration, release, *,
                        n_steps: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's expressions, one sweep per
    loop step, on whatever device the inputs lie on."""
    b, s, p1 = pred.shape
    idx = pred.reshape(b, s * p1).long()
    end = torch.zeros((b, s + 1), dtype=torch.float32, device=pred.device)
    for _ in range(n_steps):
        g = torch.gather(end, 1, idx).view(b, s, p1)
        ready = ((g + lat) + volbw).amax(dim=2)
        end[:, :s] = duration + torch.maximum(release, ready.clamp_min(0.0))
    return end[:, :s].clone()


@functools.cache
def _launcher():
    lib = build.load("sim_relax_pop")
    fn = lib.sim_relax_pop
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.sim_relax_pop_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def sim_relax_pop_cuda(pred, lat, volbw, duration, release, *,
                       n_steps: int) -> torch.Tensor:
    """Launch the kernel on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes, types, contiguity, index
    bounds, the shared-memory size and that B and S are non-zero."""
    fn, err_str = _launcher()
    b, s, p1 = pred.shape
    out = torch.empty((b, s), dtype=torch.float32, device=pred.device)
    threads = min(1024, -(-s // 32) * 32)
    with torch.cuda.device(pred.device):
        err = fn(pred.data_ptr(), lat.data_ptr(), volbw.data_ptr(),
                 duration.data_ptr(), release.data_ptr(), out.data_ptr(),
                 b, s, p1, n_steps, threads,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim_relax_pop launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
