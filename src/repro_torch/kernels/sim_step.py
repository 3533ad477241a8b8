"""Max-plus relaxations: the CUDA kernels' launchers and their plain
PyTorch versions.

**Dense** (``sim_step`` / ``sim_relax``, ``csrc/sim_step.cu``). One
synchronous (Jacobi) sweep over dense lag tensors:

    end'[b, s] = duration[b, s]
               + max(release[b, s],
                     max(max_j((end[b, j] + lat[b, s, j]) + volbw[b, s, j]),
                         0))

``end``/``duration``/``release`` (B, S) float32, ``lat``/``volbw``
(B, S, S) float32 with ``-inf`` where ``j`` does not gate ``s``
(:func:`repro_torch.core.lowering.dense_lags` builds them).
``sim_relax`` runs ``n_steps`` sweeps from all-zero ends.

**Sparse population** (``sim_relax_pop``, ``csrc/sim_relax_pop.cu``).
``n_steps`` synchronous sweeps, from all-zero ends, of

    end[b, s] = duration[b, s]
              + max(release[b, s],
                    max(max_p((end[b, pred[b, s, p]] + lat[b, s, p])
                              + volbw[b, s, p]), 0))

over the padded gather form: ``pred`` (B, S, P+1) int32 sources with the
sentinel ``S`` (an always-zero slot), ``lat``/``volbw`` (B, S, P+1)
float32 per-edge lags with ``-inf`` pads, ``duration``/``release`` (B, S)
float32. Returns (B, S) float32 finish times.

:mod:`repro_torch.kernels.ops` holds the guarded entry points that pick
between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_SHARED_BYTES = 232_448          # dynamic shared memory one block may use


def shared_bytes(s: int) -> int:
    """Shared memory of one ``sim_relax_pop`` block: the double-buffered
    (S+1)-slot ends."""
    return 2 * (s + 1) * 4



def sim_step_torch(end, lat, volbw, duration, release) -> torch.Tensor:
    """Plain PyTorch version of one dense sweep: the kernel's
    expressions on whatever device the inputs lie on. NaN propagates
    (``amax``, ``torch.maximum``)."""
    ready = ((end[:, None, :] + lat) + volbw).amax(dim=2)
    zero = torch.zeros((), dtype=ready.dtype, device=ready.device)
    return duration + torch.maximum(release, torch.maximum(ready, zero))


def sim_relax_torch(lat, volbw, duration, release, *,
                    n_steps: int) -> torch.Tensor:
    """Plain PyTorch version of ``n_steps`` dense sweeps from zeros."""
    b, s, _ = lat.shape
    end = torch.zeros((b, s), dtype=torch.float32, device=lat.device)
    for _ in range(n_steps):
        end = sim_step_torch(end, lat, volbw, duration, release)
    return end


@functools.cache
def _dense_library():
    lib = build.load("sim_step")
    lib.sim_step_fits.argtypes = [ctypes.c_int]
    lib.sim_step_fits.restype = ctypes.c_int
    lib.sim_step_shared_bytes.argtypes = [ctypes.c_int]
    lib.sim_step_shared_bytes.restype = ctypes.c_longlong
    lib.sim_step_max_shared_bytes.argtypes = []
    lib.sim_step_max_shared_bytes.restype = ctypes.c_int
    return lib


def dense_refusal(s: int) -> str | None:
    """Why the dense kernel cannot take ``S`` (a block stages the end
    row in shared memory, as the library states it), or None if it
    can."""
    lib = _dense_library()
    if lib.sim_step_fits(s):
        return None
    return (f"S={s} needs {lib.sim_step_shared_bytes(s)} bytes of shared "
            f"memory per block, more than the "
            f"{lib.sim_step_max_shared_bytes()} a block may use")


def dense_shared_bytes(s: int) -> int:
    """Shared memory one ``sim_step`` block uses (from the library)."""
    return _dense_library().sim_step_shared_bytes(s)


@functools.cache
def _dense_launchers():
    lib = _dense_library()
    step = lib.sim_step
    step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    step.restype = ctypes.c_int
    relax = lib.sim_relax
    relax.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    relax.restype = ctypes.c_int
    err_str = lib.sim_step_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return step, relax, err_str


def _raise_on(err: int, name: str, err_str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def sim_step_cuda(end, lat, volbw, duration, release) -> torch.Tensor:
    """Launch one dense sweep on the current stream of the inputs'
    device. Unguarded: the caller has checked shapes, types, contiguity,
    :func:`dense_refusal` and that B and S are non-zero."""
    step, _, err_str = _dense_launchers()
    b, s = end.shape
    out = torch.empty((b, s), dtype=torch.float32, device=end.device)
    with torch.cuda.device(end.device):
        err = step(end.data_ptr(), lat.data_ptr(), volbw.data_ptr(),
                   duration.data_ptr(), release.data_ptr(), out.data_ptr(),
                   b, s, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_step", err_str)
    return out


def sim_relax_cuda(lat, volbw, duration, release, *,
                   n_steps: int) -> torch.Tensor:
    """Launch ``n_steps`` dense sweeps from zeros on the current stream,
    two end buffers in ping-pong (never in place). Unguarded, as
    :func:`sim_step_cuda`."""
    _, relax, err_str = _dense_launchers()
    b, s, _ = lat.shape
    out = torch.zeros((b, s), dtype=torch.float32, device=lat.device)
    scratch = torch.zeros_like(out)
    with torch.cuda.device(lat.device):
        err = relax(lat.data_ptr(), volbw.data_ptr(), duration.data_ptr(),
                    release.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    b, s, n_steps, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_relax", err_str)
    return out


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
    _raise_on(err, "sim_relax_pop", err_str)
    return out
