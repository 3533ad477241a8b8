"""AdamW over every parameter tensor of a step: the CUDA kernels'
launchers and their plain PyTorch versions.

    sumsq[t] = sum(g_t^2)                          (the clip's norm)
    g = g * clip
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    p = cast(p - lr * ((m / b1c) / (sqrt(v / b2c) + eps) + wd * p))

over lists of tensors: ``p`` and ``g`` each bf16 or float32, ``m`` and
``v`` float32, everything between the loads and the cast back float32.
``clip``, ``lr``, ``b1c`` and ``b2c`` are float32 scalars on the device;
``b1``, ``b2``, ``eps`` and ``wd`` Python floats. The plain versions are
the expressions :func:`repro_torch.optim.adamw.apply_updates` ran one
tensor at a time; the CUDA kernels in ``csrc/adamw.cu`` cover all the
tensors of a call in a fixed number of launches (the sums of squares
two, the update one), whatever their number. The update is bit for bit
the plain version's given the same scalars; the sums of squares are
taken in float64 in a fixed order (no atomics), so they repeat bit for
bit and differ from ``torch.sum``'s float32 reduction by its rounding.
:func:`repro_torch.kernels.ops.grad_sumsq` and
:func:`repro_torch.kernels.ops.adamw_update` are the guarded entry
points that pick between the two.

The kernels walk a table built here on the host from the tensors'
shapes and addresses (:func:`table_words`): a record of
:data:`TENSOR_WORDS` int64 words a tensor, then :func:`chunk_table`'s
(tensor, element offset) pairs, chunks of :data:`CHUNK` elements with
64-bit offsets (one step's 3.4 B elements pass 2**31). It reaches the
card by an asynchronous copy from pinned memory on the launch's stream;
PyTorch's pinned allocator keeps the buffer until that copy is done.
Nothing is read back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..spans import launch
from . import build

#: elements a chunk (``kChunk`` in csrc/adamw.cu): a multiple of 8 (a
#: thread's vector), small enough that the last round of a persistent
#: grid stays short
CHUNK = 1 << 16
TENSOR_WORDS = 8                # p, g, m, v, numel, flags, first chunk, chunks
#: flags of a tensor record, as csrc/adamw.cu reads them
P_BF16, G_BF16, G_VEC, ALL_VEC = 1, 2, 4, 8


def grad_sumsq_torch(grads) -> torch.Tensor:
    """Plain PyTorch version: float32 (n,), the sum of squares of each
    gradient in float32."""
    return torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads])


def adamw_update_torch(params, grads, ms, vs, *, clip, lr, b1c, b2c,
                       b1: float, b2: float, eps: float,
                       weight_decay: float) -> None:
    """Plain PyTorch version: updates each ``params[i]``, ``ms[i]`` and
    ``vs[i]`` in place, one tensor at a time."""
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g.to(torch.float32) * clip
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        del g
        pf = p.to(torch.float32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))


def chunk_table(shapes):
    """The chunks of tensors of ``shapes``, from the shapes alone:
    (``pairs`` (C, 2) int64 rows of (tensor index, element offset), in
    tensor order and, within a tensor, in offset order; ``first`` (T + 1,)
    int64, tensor t's chunks at rows ``first[t]:first[t + 1]``). Chunk
    ``(t, o)`` covers elements ``o`` to ``min(o + CHUNK, numel_t)`` of
    tensor t; an empty tensor has none."""
    numels = np.array([math.prod(s) for s in shapes], dtype=np.int64)
    counts = -(-numels // CHUNK)
    first = np.zeros(len(numels) + 1, dtype=np.int64)
    np.cumsum(counts, out=first[1:])
    tensor = np.repeat(np.arange(len(numels), dtype=np.int64), counts)
    offset = (np.arange(first[-1], dtype=np.int64) - first[tensor]) * CHUNK
    return np.stack([tensor, offset], axis=1), first


def table_words(addresses, shapes, flags):
    """The kernels' table as one int64 array: a record of
    :data:`TENSOR_WORDS` words a tensor (``addresses`` (T, 4) of p, g, m,
    v, 0 where unused; the numel; ``flags`` (T,); the first chunk and the
    chunk count), then :func:`chunk_table`'s pairs. Returns (words, number
    of chunks)."""
    pairs, first = chunk_table(shapes)
    rec = np.zeros((len(shapes), TENSOR_WORDS), dtype=np.int64)
    rec[:, :4] = addresses
    rec[:, 4] = [math.prod(s) for s in shapes]
    rec[:, 5] = flags
    rec[:, 6] = first[:-1]
    rec[:, 7] = np.diff(first)
    return np.concatenate([rec.ravel(), pairs.ravel()]), len(pairs)


def _flags(addresses, p_bf16, g_bf16) -> np.ndarray:
    """Each tensor's flags: its dtypes, g's alignment and all four's
    (16 bytes, the kernels' vector loads)."""
    aligned = addresses % 16 == 0
    return (P_BF16 * np.asarray(p_bf16, dtype=np.int64)
            + G_BF16 * np.asarray(g_bf16, dtype=np.int64)
            + G_VEC * aligned[:, 1] + ALL_VEC * aligned.all(axis=1))


def _upload(words: np.ndarray, device) -> torch.Tensor:
    """``words`` on ``device``, copied on its current stream from pinned
    memory without waiting."""
    return torch.from_numpy(words).pin_memory().to(device, non_blocking=True)


@functools.cache
def _library():
    lib = build.load("adamw")
    lib.adamw_grad_sumsq.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong] \
        + [ctypes.c_void_p] * 3
    lib.adamw_grad_sumsq.restype = ctypes.c_int
    lib.adamw_update.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
    lib.adamw_update.restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.adamw_error_string(err).decode()})")


def grad_sumsq_cuda(grads) -> torch.Tensor:
    """Launch the sums of squares (per-chunk partials, then a per-tensor
    finish) on the current stream of the gradients' device; returns
    float32 (n,). Unguarded: the caller has checked types, one device,
    contiguity and that the list is not empty."""
    lib = _library()
    device = grads[0].device
    addresses = np.zeros((len(grads), 4), dtype=np.int64)
    addresses[:, 1] = [g.data_ptr() for g in grads]
    flags = _flags(addresses, np.zeros(len(grads), dtype=bool),
                   [g.dtype == torch.bfloat16 for g in grads])
    words, n_chunks = table_words(addresses, [g.shape for g in grads], flags)
    if n_chunks == 0:
        return torch.zeros(len(grads), dtype=torch.float32, device=device)
    out = torch.empty(len(grads), dtype=torch.float32, device=device)
    # float64 partials on the card: the chunks' sums, exact enough that
    # the float32 result is rounded once
    partial = torch.empty(n_chunks, dtype=torch.float64,  # lint: dtype-ok
                          device=device)
    with torch.cuda.device(device):
        table = _upload(words, device)
        with launch("adamw.grad_sumsq"):
            err = lib.adamw_grad_sumsq(
                table.data_ptr(), len(grads), n_chunks,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "adamw_grad_sumsq")
    return out


def adamw_update_cuda(params, grads, ms, vs, *, clip, lr, b1c, b2c,
                      b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """Launch the update of every tensor in place, once, on the current
    stream of the parameters' device. Unguarded: the caller has checked
    types, shapes, one device and contiguity."""
    lib = _library()
    device = params[0].device
    addresses = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(),
                           v.data_ptr()]
                          for p, g, m, v in zip(params, grads, ms, vs)],
                         dtype=np.int64).reshape(-1, 4)
    flags = _flags(addresses, [p.dtype == torch.bfloat16 for p in params],
                   [g.dtype == torch.bfloat16 for g in grads])
    words, n_chunks = table_words(addresses, [p.shape for p in params],
                                  flags)
    if n_chunks == 0:
        return
    with torch.cuda.device(device):
        table = _upload(words, device)
        # the constants go as float32, rounded from the Python floats as
        # PyTorch rounds a scalar operand of a float32 tensor
        with launch("adamw.update"):
            err = lib.adamw_update(
                table.data_ptr(), len(params), n_chunks,
                clip.data_ptr(), lr.data_ptr(), b1c.data_ptr(),
                b2c.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
                torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "adamw_update")
    # written through raw pointers: tell autograd, as an in-place op would
    torch.autograd.graph.increment_version(params + ms + vs)
