"""Batched admission scoring: the CUDA kernel's launcher and its plain
PyTorch version.

``BatchedPolicy(scorer="kernel")`` scores the whole (apps × cores)
candidate matrix against a frozen snapshot of the cluster timeline in
one call:

    score[i, j] = max(frontier[j], release[i]) + drain[i, j]

``drain[i, j]`` is app *i*'s serial drain time on core *j*
(:func:`repro_torch.core.lowering.drain_matrix`), ``frontier[j]`` the
earliest instant core *j* can take appended work and ``release[i]`` the
app's release floor; ``min_j score[i, j]`` is a drain-on-one-core
completion estimate. All float32: ``drain`` (A, C), ``frontiers`` (C,),
``release`` (A,), result (A, C). The max follows ``np.maximum``'s rule
(NaN propagates; for equal operands the release wins), so both versions
equal the NumPy oracle ``ref.sched_score_np`` bit for bit. The CUDA
kernel lives in ``csrc/sched_score.cu``;
:func:`repro_torch.kernels.ops.sched_score` is the guarded entry point
that picks between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def sched_score_torch(drain, frontiers, release) -> torch.Tensor:
    """Plain PyTorch version: the kernel's expressions, on whatever
    device the inputs lie on."""
    f = frontiers[None, :]
    r = release[:, None]
    return torch.where(torch.isnan(f) | (f > r), f, r) + drain


@functools.cache
def _launcher():
    lib = build.load("sched_score")
    fn = lib.sched_score
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.sched_score_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def sched_score_cuda(drain, frontiers, release) -> torch.Tensor:
    """Launch the kernel on the current stream of the inputs' device.
    Unguarded: the caller has checked shapes, types, contiguity and that
    A and C are non-zero; a launch the card refuses raises here."""
    fn, err_str = _launcher()
    a, c = drain.shape
    out = torch.empty((a, c), dtype=torch.float32, device=drain.device)
    with torch.cuda.device(drain.device):
        err = fn(drain.data_ptr(), frontiers.data_ptr(), release.data_ptr(),
                 out.data_ptr(), a, c,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sched_score launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
