"""NumPy oracles of the port's kernels (copies of the JAX package's, so
the port imports nothing from it).

``sim_step_ref`` is the oracle of one dense ``sim_step`` sweep,
``pop_relax_np`` the float32 oracle of ``sim_relax_pop`` and
``sched_score_np`` that of ``sched_score``: the same expressions in the
same float32 arithmetic, so each kernel and its plain PyTorch version
equal them bit for bit.
"""

from __future__ import annotations

import numpy as np


def sim_step_ref(end, lat, volbw, duration, release) -> np.ndarray:
    """NumPy oracle for one dense relaxation sweep (dtype-preserving).

    ``end`` (B, S); ``lat``/``volbw`` (B, S, S) with ``-inf`` non-edges;
    ``duration``/``release`` (B, S)."""
    end = np.asarray(end)
    ready = ((end[:, None, :] + np.asarray(lat))
             + np.asarray(volbw)).max(axis=-1, initial=-np.inf)
    zero = end.dtype.type(0.0)
    return np.asarray(duration) + np.maximum(np.asarray(release),
                                             np.maximum(ready, zero))


def pop_step_np(end, pred, lat, volbw, duration, release) -> np.ndarray:
    """NumPy oracle for one sparse population sweep (dtype-preserving).

    ``end`` (B, E) finish times with every sentinel slot holding 0;
    ``pred`` (B, S, P) int gather sources into the E axis (pads point at
    a sentinel slot); ``lat``/``volbw`` (B, S, P) with ``-inf`` pads;
    ``duration``/``release`` (B, S). The two-add shape ``(end + lat) +
    volbw`` matches the event simulator's ``now + latency + vol/bw``."""
    end = np.asarray(end)
    b = end.shape[0]
    g = end[np.arange(b)[:, None, None], np.asarray(pred)]
    ready = ((g + np.asarray(lat)) + np.asarray(volbw)).max(axis=-1,
                                                            initial=-np.inf)
    zero = end.dtype.type(0.0)
    return np.asarray(duration) + np.maximum(np.asarray(release),
                                             np.maximum(ready, zero))


def pop_relax_np(pred, lat, volbw, duration, release, *,
                 n_steps: int) -> np.ndarray:
    """Iterated float32 oracle for ``sim_relax_pop`` — bit-for-bit the
    kernel's result (same expressions, same f32 arithmetic).
    Sentinel convention: ``pred == S`` points at an always-zero slot."""
    pred = np.asarray(pred)
    b, s, _ = pred.shape
    lat = np.asarray(lat, np.float32)
    volbw = np.asarray(volbw, np.float32)
    duration = np.asarray(duration, np.float32)
    release = np.asarray(release, np.float32)
    end = np.zeros((b, s + 1), np.float32)
    for _ in range(n_steps):
        end[:, :s] = pop_step_np(end, pred, lat, volbw, duration, release)
    return np.array(end[:, :s])


def sched_score_np(drain, frontiers, release) -> np.ndarray:
    """Oracle for ``sched_score``: elementwise
    ``max(frontier[j], release[i]) + drain[i, j]`` over the
    (apps × cores) candidate matrix."""
    drain = np.asarray(drain, np.float32)
    f = np.asarray(frontiers, np.float32)[None, :]
    r = np.asarray(release, np.float32)[:, None]
    return np.maximum(f, r) + drain
