"""Batched admission scoring: the CUDA kernel's launcher and its plain
PyTorch version.

``BatchedPolicy(scorer="kernel")`` scores the whole (apps × cores)
candidate matrix against a frozen snapshot of the cluster timeline in
one call:

    score[i, j] = max(frontier[j], release[i]) + drain[i, j]
    row_min[i]  = min_j score[i, j]

``drain[i, j]`` is app *i*'s serial drain time on core *j*
(:func:`repro_torch.core.lowering.drain_matrix`), ``frontier[j]`` the
earliest instant core *j* can take appended work and ``release[i]`` the
app's release floor; ``row_min[i]`` is a drain-on-one-core completion
estimate, the only number the policy uses. All float32: ``drain`` (A,
C), ``frontiers`` (C,), ``release`` (A,), results (A, C) and (A,). The
max follows ``np.maximum``'s rule (NaN propagates; for equal operands the
release wins), so both versions' matrices equal the NumPy oracle
``ref.sched_score_np`` bit for bit; the minimum follows
``ndarray.min(axis=1)`` (NaN propagates) and equals it under ``==``. The
CUDA kernel lives in ``csrc/sched_score.cu`` and computes both in one
launch; :func:`repro_torch.kernels.ops.sched_score` is the guarded entry
point that picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def sched_score_torch(drain, frontiers, release, *, row_min: bool = False):
    """Plain PyTorch version: the kernel's expressions, on whatever
    device the inputs lie on. Returns the (A, C) matrix, or ``(matrix,
    row minima)`` with ``row_min`` (C must then be non-zero)."""
    f = frontiers[None, :]
    r = release[:, None]
    score = torch.where(torch.isnan(f) | (f > r), f, r) + drain
    if not row_min:
        return score
    return score, torch.amin(score, dim=1)


def vector_path(drain, frontiers, score) -> bool:
    """Whether the kernel moves 16 bytes a lane (``float4``): C a multiple
    of 4 and drain, frontiers and score 16-byte aligned. The launch rule,
    kept here so that it is tested on the CPU."""
    return drain.shape[1] % 4 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (drain, frontiers, score))


@functools.cache
def _library():
    lib = build.load("sched_score")
    lib.sched_score.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.sched_score.restype = ctypes.c_int
    lib.sched_score_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.sched_score_empty.restype = ctypes.c_int
    lib.sched_score_error_string.argtypes = [ctypes.c_int]
    lib.sched_score_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.sched_score_error_string(err).decode()})")


def sched_score_cuda(drain, frontiers, release, *, row_min: bool = False):
    """Launch the kernel once on the current stream of the inputs'
    device; returns what :func:`sched_score_torch` returns. Unguarded:
    the caller has checked shapes, types, contiguity and that A and C are
    non-zero; a launch the card refuses raises here."""
    lib = _library()
    a, c = drain.shape
    out = torch.empty((a, c), dtype=torch.float32, device=drain.device)
    mins = torch.empty((a,), dtype=torch.float32, device=drain.device) \
        if row_min else None
    with torch.cuda.device(drain.device):
        err = lib.sched_score(
            drain.data_ptr(), frontiers.data_ptr(), release.data_ptr(),
            out.data_ptr(), None if mins is None else mins.data_ptr(), a, c,
            int(vector_path(drain, frontiers, out)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sched_score")
    return out if mins is None else (out, mins)


def empty_cuda(a: int, device) -> None:
    """Launch an empty kernel on the kernel's grid for ``a`` rows: the
    launch floor a timing of :func:`sched_score_cuda` is read against.
    Not counted as a launch of the kernel."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.sched_score_empty(a, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sched_score_empty")
