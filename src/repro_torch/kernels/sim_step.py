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
float32. Returns (B, S) float32 finish times. The kernel stops a row at
its first sweep that leaves the ends unchanged bit for bit, which gives
the ``n_steps`` result bit for bit; it launches a thread-block cluster
of ``k`` CTAs per row and stages the edge inputs in shared memory where
they fit, both by :func:`pop_plan`.

:mod:`repro_torch.kernels.ops` holds the guarded entry points that pick
between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

MAX_SHARED_BYTES = 232_448          # dynamic shared memory one block may use
SMS = 132                           # H100 SXM streaming multiprocessors
SM_SHARED_BYTES = 233_472           # shared memory of one SM (228 KB)
CTA_RESERVED_BYTES = 1_024          # shared memory the system keeps per block
MAX_CLUSTER = 16                    # CTAs of a cluster (non-portable > 8)
MIN_SLICE = 32                      # least subtasks a CTA of a cluster keeps
FLAG_BYTES = 16                     # the kernel's two vote slots, padded


class PopPlan(NamedTuple):
    """How ``sim_relax_pop`` launches for one shape: ``k`` CTAs (a
    thread-block cluster) per row, ``variant`` ``"staged"`` (the slice's
    edge inputs copied once into shared memory) or ``"l2"`` (read from
    L2 every sweep), the dynamic shared memory of one CTA, and its
    threads."""
    k: int
    variant: str
    shared_bytes: int
    threads: int


def shared_bytes(s: int) -> int:
    """Shared memory of the double-buffered (S+1)-slot ends, which every
    CTA of a cluster holds whole."""
    return 2 * (s + 1) * 4


def pop_shared_bytes(s: int, p1: int, slice_: int, staged: bool) -> int:
    """Shared memory of one ``sim_relax_pop`` CTA (the layout of
    ``csrc/sim_relax_pop.cu``, whose launch takes these bytes from the
    plan): the vote flags and the two end buffers; staged, also the
    slice's lat and volbw (float32), dur and rel, and pred narrowed to 16
    bits, padded to 4 bytes."""
    n = FLAG_BYTES + shared_bytes(s)
    if staged:
        e = slice_ * p1
        n += 8 * e + 8 * slice_ + (2 * e + 3) // 4 * 4
    return n


def pop_plan(b: int, s: int, p1: int) -> PopPlan:
    """The launch rule of ``sim_relax_pop``, by shape alone. ``k`` is the
    largest power of two up to 16 for which the B * k CTAs fit the 132
    SMs once and each CTA keeps at least 32 subtasks (so a small
    population spreads over the card and a large one keeps one CTA per
    row). The staged variant is taken when one CTA's staged bytes fit a
    block and the population's fit the card's shared memory in one wave;
    else the L2 variant, which holds only the ends. Threads: one per
    subtask of the slice, in whole warps, at most 1024."""
    k = 1
    while (2 * k <= MAX_CLUSTER and b * 2 * k <= SMS
           and -(-s // (2 * k)) >= MIN_SLICE):
        k *= 2
    slice_ = -(-s // k)
    threads = min(1024, -(-slice_ // 32) * 32)
    staged = pop_shared_bytes(s, p1, slice_, True)
    if (staged <= MAX_SHARED_BYTES
            and b * k * (staged + CTA_RESERVED_BYTES)
            <= SMS * SM_SHARED_BYTES):
        return PopPlan(k, "staged", staged, threads)
    return PopPlan(k, "l2", pop_shared_bytes(s, p1, slice_, False), threads)


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


def fixpoint_sweeps_torch(pred, lat, volbw, duration, release, *,
                          n_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's stop, in plain PyTorch: the same sweeps as
    :func:`sim_relax_pop_torch`, each row stopped at its first sweep that
    leaves its ends unchanged bit for bit. Returns the (B, S) ends and
    the (B,) int32 sweeps each row ran (that sweep counted; ``n_steps``
    for a row that never settles), what the kernel reports."""
    b, s, p1 = pred.shape
    idx = pred.reshape(b, s * p1).long()
    end = torch.zeros((b, s + 1), dtype=torch.float32, device=pred.device)
    sweeps = torch.zeros(b, dtype=torch.int32, device=pred.device)
    live = torch.ones(b, dtype=torch.bool, device=pred.device)
    for _ in range(n_steps):
        if not bool(live.any()):
            break
        g = torch.gather(end, 1, idx).view(b, s, p1)
        ready = ((g + lat) + volbw).amax(dim=2)
        new = duration + torch.maximum(release, ready.clamp_min(0.0))
        same = (new.view(torch.int32) == end[:, :s].view(torch.int32)).all(1)
        sweeps += live.int()
        end[live, :s] = new[live]
        live &= ~same
    return end[:, :s].clone(), sweeps


@functools.cache
def _library():
    lib = build.load("sim_relax_pop")
    fn = lib.sim_relax_pop
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sim_relax_pop_error_string.argtypes = [ctypes.c_int]
    lib.sim_relax_pop_error_string.restype = ctypes.c_char_p
    lib.sim_relax_pop_max_active_clusters.argtypes = [ctypes.c_int] * 3 \
        + [ctypes.c_longlong]
    lib.sim_relax_pop_max_active_clusters.restype = ctypes.c_int
    return lib


@functools.cache
def max_active_clusters(plan: PopPlan, device_index: int) -> int:
    """Clusters of the plan's kind the device holds at once (the
    library's ``cudaOccupancyMaxActiveClusters``); 0 means it cannot
    run one."""
    lib = _library()
    with torch.cuda.device(device_index):
        n = lib.sim_relax_pop_max_active_clusters(
            plan.k, int(plan.variant == "staged"), plan.threads,
            plan.shared_bytes)
    if n < 0:
        raise RuntimeError(
            f"sim_relax_pop: occupancy query failed: CUDA error {-n} "
            f"({lib.sim_relax_pop_error_string(-n).decode()})")
    return n


def sim_relax_pop_cuda(pred, lat, volbw, duration, release, *,
                       n_steps: int, with_sweeps: bool = False):
    """Launch the kernel on the current stream of the inputs' device with
    :func:`pop_plan`'s cluster and variant. Returns the (B, S) ends, and
    with ``with_sweeps`` also the (B,) int32 sweeps each row ran.
    Raises if the device cannot hold one such cluster. Unguarded
    otherwise: the caller has checked shapes, types, contiguity, index
    bounds, the shared-memory size and that B and S are non-zero."""
    lib = _library()
    b, s, p1 = pred.shape
    plan = pop_plan(b, s, p1)
    dev = pred.device.index if pred.device.index is not None \
        else torch.cuda.current_device()
    if max_active_clusters(plan, dev) < 1:
        raise RuntimeError(
            f"sim_relax_pop: the device cannot hold one cluster of "
            f"{plan.k} CTAs of {plan.threads} threads with "
            f"{plan.shared_bytes} bytes of shared memory each "
            f"({plan.variant} variant at B={b}, S={s}, P+1={p1})")
    out = torch.empty((b, s), dtype=torch.float32, device=pred.device)
    sweeps = torch.empty(b, dtype=torch.int32, device=pred.device) \
        if with_sweeps else None
    with torch.cuda.device(pred.device):
        err = lib.sim_relax_pop(
            pred.data_ptr(), lat.data_ptr(), volbw.data_ptr(),
            duration.data_ptr(), release.data_ptr(), out.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(), b, s, p1,
            n_steps, plan.k, int(plan.variant == "staged"), plan.threads,
            plan.shared_bytes, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sim_relax_pop", lib.sim_relax_pop_error_string)
    return (out, sweeps) if with_sweeps else out
