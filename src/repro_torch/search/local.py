"""Hill-climbing local refiner over single-task move neighborhoods.

The GA's crossover explores coarse structure; the refiner polishes its
winner with the classic move neighborhood — pick one task, reassign it
to a different core — evaluated the same way the GA scores generations:
all sampled neighbors of a round are decoded and lowered into one
:class:`~repro_torch.core.lowering.ScenarioBatch` and scored by one
``simulate_batch`` call (on the card by default). Steepest-descent
accept (best neighbor if it improves), stop on the first round with no
improvement.

:func:`hill_climb_device` is the device-resident twin: the same
neighborhood and accept rule, but neighbors are drawn from the device
GA's ``torch.Generator`` (no host RNG) and scored by a device fitness
callable (``repro_torch.search.device``), so the refine stage of
``GAParams(device=True)`` runs is deterministic under one seed too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lowering
from ..core.machine import MachineModel
from ..core.mpaha import AppGraph
from ..core.sim_engine import simulate_batch
from .encoding import decode_population

# fitness backend -> where simulate_batch runs it: the kernel on the
# card, its plain version on the CPU, or the float64 NumPy pass
FITNESS_DEVICE = {"cuda": "cuda", "torch": "cpu", "numpy": "cpu"}


def batch_fitness(batch: lowering.ScenarioBatch,
                  backend: str) -> np.ndarray:
    """(B,) as-executed makespans of a lowered population on
    ``backend`` (``"cuda"``, ``"torch"`` or ``"numpy"``)."""
    return simulate_batch(batch, backend=backend,
                          device=FITNESS_DEVICE[backend]).t_exec


def _neighbors(vec: np.ndarray, rng: np.random.Generator, moves: int,
               n_cores: int) -> np.ndarray:
    """(M, n_tasks) sampled single-task reassignments of ``vec``."""
    n_tasks = len(vec)
    full = n_tasks * (n_cores - 1)
    m = min(moves, full)
    # sample (task, new core) pairs without replacement over the flat
    # neighborhood index; new-core slots skip the current core
    flat = rng.choice(full, size=m, replace=False)
    tasks = flat // (n_cores - 1)
    shift = flat % (n_cores - 1)
    new_core = np.where(shift < vec[tasks], shift, shift + 1)
    out = np.tile(vec, (m, 1))
    out[np.arange(m), tasks] = new_core.astype(np.int32)
    return out


def hill_climb(graph: AppGraph, machine: MachineModel, vec: np.ndarray,
               fit: float, *, rng: np.random.Generator, rounds: int = 3,
               moves: int = 48,
               releases: dict[int, float] | None = None,
               frozen: dict | None = None,
               backend: str = "cuda") -> tuple[np.ndarray, float]:
    """Refine ``vec`` (current fitness ``fit``); returns the improved
    ``(vector, fitness)``. Deterministic given ``rng``'s state.
    ``frozen`` pins immutable history into every candidate."""
    n_cores = machine.n_cores
    if n_cores < 2 or len(vec) == 0:
        return vec, fit
    for _ in range(rounds):
        neigh = _neighbors(vec, rng, moves, n_cores)
        schedules = decode_population(graph, machine, neigh,
                                      releases=releases, frozen=frozen)
        batch = lowering.lower_population(graph, machine, schedules,
                                          releases=releases)
        f = batch_fitness(batch, backend)
        best = int(np.argmin(f))
        if f[best] >= fit - 1e-12:
            break
        vec, fit = neigh[best].copy(), float(f[best])
    return vec, fit


def hill_climb_device(fitness_fn, inp, vec: np.ndarray, fit: float, *,
                      generator: torch.Generator, rounds: int = 3,
                      moves: int = 48,
                      n_cores: int) -> tuple[np.ndarray, float]:
    """Device-scored hill climb: ``fitness_fn(inp, genes)`` maps a
    (M, n_tasks) population on ``inp``'s device to (M,) makespans (the
    device GA's fitness callable); neighbors are the first ``M`` of a
    ``randperm`` of the flat (task, new-core) index drawn from
    ``generator`` — sampling without replacement. Same neighborhood,
    accept rule and stop rule as :func:`hill_climb`."""
    vec = np.asarray(vec, np.int32)
    n_tasks = len(vec)
    if n_cores < 2 or n_tasks == 0:
        return vec, fit
    dev = inp.device
    full = n_tasks * (n_cores - 1)
    m = min(moves, full)
    rows = torch.arange(m, device=dev)
    for _ in range(rounds):
        flat = torch.randperm(full, generator=generator, device=dev)[:m]
        tasks = flat // (n_cores - 1)
        shift = flat % (n_cores - 1)
        base = torch.as_tensor(vec, device=dev)
        new_core = torch.where(shift < base[tasks], shift, shift + 1)
        neigh = base.repeat(m, 1)
        neigh[rows, tasks] = new_core.to(torch.int32)
        f = fitness_fn(inp, neigh).cpu().numpy()
        best = int(np.argmin(f))
        if f[best] >= fit - 1e-12:
            break
        vec, fit = neigh[best].cpu().numpy().astype(np.int32), float(f[best])
    return vec, fit
