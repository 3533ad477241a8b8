"""Bias-elitist genetic mapping search with batched-simulator fitness.

AMTHA is a one-shot heuristic: it commits each task to a core once and
never revisits the decision. When mapping evaluations are cheap — and
the batched array simulator makes a whole population cost one
``simulate_batch`` call — a population-based search can spend those
evaluations exploring the ``C^n_tasks`` assignment grid instead
(Quan & Pimentel, "Exploring Task Mappings on Heterogeneous MPSoCs
using a Bias-Elitist Genetic Algorithm"). The scheme here:

* chromosomes are ``(task -> core)`` vectors (``search/encoding.py``);
* the initial population is *seeded with the AMTHA/engine placement as
  an elite individual* (plus uniform-random rest), and the final answer
  is the better of the best evolved schedule and the heuristic's own —
  so the GA is never worse than the heuristic it starts from;
* fitness of a generation = decode every chromosome, lower the decoded
  schedules of the shared (graph, machine) to one
  :class:`~repro_torch.core.lowering.ScenarioBatch`
  (:func:`~repro_torch.core.lowering.lower_population`) and run
  :func:`~repro_torch.core.sim_engine.simulate_batch` — the analytic
  as-executed makespan of every candidate in one call. The default
  ``backend="cuda"`` runs that sweep on the card through the
  hand-written ``sim_relax_pop`` kernel (float32); ``"torch"`` runs its
  plain PyTorch version on the CPU and ``"numpy"`` the float64 wave pass
  the reference uses by default;
* selection is tournament with an elite bias (a configurable fraction
  of parent draws come from the elite pool), recombination is uniform
  crossover, mutation resamples each gene with probability
  ``~1/n_tasks``, and the top ``elite`` individuals survive unchanged;
* a hill-climbing local refiner (``search/local.py``) polishes the
  final best vector with batched single-task move evaluations.

Registered as ``SCHEDULERS["ga"]`` (task-coherent, offline), so
callers reach it by name. ``GAParams(device=True)`` runs the whole
loop on one device instead (``search/device.py``): on the card with
``backend="cuda"``, on the CPU with ``backend="torch"``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..core import lowering
from ..core.machine import MachineModel
from ..core.mpaha import AppGraph
from ..core.timeline import Timeline
from .encoding import decode, decode_population, encode
from .local import FITNESS_DEVICE, batch_fitness, hill_climb


@dataclass(frozen=True)
class GAParams:
    """Search budget and operator rates (defaults sized so the full
    ``--scheduler ga`` paper tables stay minutes, not hours). Validated
    on construction — a bad budget fails loudly at the call site, not
    as a silent empty population deep in the loop."""

    pop_size: int = 32
    generations: int = 24
    elite: int = 2                  # individuals copied through unchanged
    tournament: int = 3
    elite_bias: float = 0.25        # P(parent drawn from the elite pool)
    p_mutation: float | None = None  # per-gene; default max(1/n_tasks, .02)
    refine_rounds: int = 3          # hill-climbing rounds on the winner
    refine_moves: int = 48          # sampled single-task moves per round
    backend: str = "cuda"           # fitness path: "cuda" | "torch" | "numpy"
    device: bool = False            # device-resident loop (search/device)

    def __post_init__(self) -> None:
        if self.pop_size < 1:
            raise ValueError(f"pop_size must be >= 1, got {self.pop_size}")
        if not 0 <= self.elite <= self.pop_size:
            raise ValueError(f"elite must be in [0, pop_size={self.pop_size}]"
                             f", got {self.elite}")
        if self.generations < 1:
            raise ValueError("generations must be positive, got "
                             f"{self.generations}")
        if self.tournament < 1:
            raise ValueError(f"tournament must be >= 1, got "
                             f"{self.tournament}")
        if not 0.0 <= self.elite_bias <= 1.0:
            raise ValueError(f"elite_bias must be in [0, 1], got "
                             f"{self.elite_bias}")
        if self.p_mutation is not None and not 0.0 <= self.p_mutation <= 1.0:
            raise ValueError(f"p_mutation must be in [0, 1] (or None), got "
                             f"{self.p_mutation}")
        if self.refine_rounds < 0 or self.refine_moves < 0:
            raise ValueError("refine_rounds/refine_moves must be >= 0, got "
                             f"{self.refine_rounds}/{self.refine_moves}")
        if self.backend not in FITNESS_DEVICE:
            raise ValueError(f"unknown fitness backend {self.backend!r} "
                             f"(expected one of {sorted(FITNESS_DEVICE)})")
        if self.device and self.backend == "numpy":
            raise ValueError("device=True runs on a torch device: backend "
                             "'cuda' (the card) or 'torch' (the CPU), not "
                             "'numpy'")


def population_fitness(graph: AppGraph, machine: MachineModel, population,
                       *, releases: dict[int, float] | None = None,
                       frozen: dict | None = None,
                       backend: str = "cuda") -> np.ndarray:
    """(B,) as-executed makespan per chromosome — decode all, lower to
    one batch, simulate once. The GA's only objective call. ``frozen``
    pins immutable history into every decoded candidate (mid-flight
    refinement; see :func:`~repro_torch.search.encoding.decode`)."""
    schedules = decode_population(graph, machine, population,
                                  releases=releases, frozen=frozen)
    batch = lowering.lower_population(graph, machine, schedules,
                                      releases=releases)
    return batch_fitness(batch, backend)


def _mutate(population: np.ndarray, rng: np.random.Generator,
            p: float, n_cores: int, keep: int) -> None:
    """Resample each gene with probability ``p`` (rows < ``keep`` are
    the protected elites)."""
    body = population[keep:]
    mask = rng.random(body.shape) < p
    body[mask] = rng.integers(0, n_cores, int(mask.sum()), dtype=np.int32)


def _tournament(fitness: np.ndarray, rng: np.random.Generator,
                k: int) -> int:
    cand = rng.integers(0, len(fitness), k)
    return int(cand[np.argmin(fitness[cand])])


def next_generation(pop: np.ndarray, fit: np.ndarray,
                    rng: np.random.Generator, par: GAParams, *,
                    p_mut: float, n_cores: int) -> np.ndarray:
    """One host selection/crossover/mutation step (sort by fitness,
    bias-elitist parent draws, uniform crossover, per-gene resampling,
    elites through unchanged) — the exact loop body of
    :func:`ga_search`, exposed so the benchmark can time the select
    phase in isolation. Consumes ``rng`` exactly as the search does."""
    n_tasks = pop.shape[1]
    order = np.argsort(fit, kind="stable")
    pop, fit = pop[order], fit[order]
    nxt = np.empty_like(pop)
    nxt[:par.elite] = pop[:par.elite]
    for i in range(par.elite, par.pop_size):
        if rng.random() < par.elite_bias:
            a = int(rng.integers(0, max(par.elite, 1)))
        else:
            a = _tournament(fit, rng, par.tournament)
        b = _tournament(fit, rng, par.tournament)
        cross = rng.random(n_tasks) < 0.5
        nxt[i] = np.where(cross, pop[a], pop[b])
    _mutate(nxt, rng, p_mut, n_cores, par.elite)
    return nxt


def ga_search(graph: AppGraph, machine: MachineModel, *, seed: int = 0,
              params: GAParams | None = None,
              elites: list[np.ndarray] | None = None,
              releases: dict[int, float] | None = None,
              frozen: dict | None = None
              ) -> tuple[np.ndarray, float]:
    """Evolve mapping vectors; returns ``(best_vector, best_fitness)``.

    ``elites`` seed the initial population (deduplicated, truncated to
    ``pop_size``); pass the encoded heuristic placement(s) here. The
    whole run is deterministic under ``seed``. ``frozen`` pins already
    started/finished placements into every candidate (recovery's
    mid-flight re-mapping).

    ``params.device=True`` routes the whole loop through the
    device-resident twin (``repro_torch.search.device``): decode,
    fitness, selection and mutation as tensor ops on one device,
    append-only decode semantics, float32 fitness. ``frozen`` history
    has data-dependent shapes and stays on the host path."""
    par = params or GAParams()
    if par.device and not frozen:
        from .device import ga_search_device

        return ga_search_device(graph, machine, seed=seed, params=par,
                                elites=elites, releases=releases)
    graph.finalize()
    n_tasks = len(graph.tasks)
    n_cores = machine.n_cores
    rng = np.random.default_rng(seed)
    p_mut = par.p_mutation if par.p_mutation is not None \
        else max(1.0 / max(n_tasks, 1), 0.02)

    pop = rng.integers(0, n_cores, (par.pop_size, n_tasks), dtype=np.int32)
    for i, e in enumerate((elites or [])[:par.pop_size]):
        pop[i] = np.asarray(e, np.int32)

    def evaluate(p):
        return population_fitness(graph, machine, p, releases=releases,
                                  frozen=frozen, backend=par.backend)

    fit = evaluate(pop)
    for _ in range(par.generations):
        pop = next_generation(pop, fit, rng, par, p_mut=p_mut,
                              n_cores=n_cores)
        fit = evaluate(pop)

    best = int(np.argmin(fit))
    vec, val = pop[best].copy(), float(fit[best])
    if par.refine_rounds > 0 and n_tasks > 0:
        vec, val = hill_climb(graph, machine, vec, val, rng=rng,
                              rounds=par.refine_rounds,
                              moves=par.refine_moves,
                              releases=releases, frozen=frozen,
                              backend=par.backend)
    return vec, val


def ga_schedule(graph: AppGraph, machine: MachineModel, *, seed: int = 0,
                params: GAParams | None = None, baseline: str = "engine",
                releases: dict[int, float] | None = None,
                **overrides) -> Timeline:
    """The registry entry point: search, then return the better of the
    best evolved schedule and the ``baseline`` heuristic's (by
    makespan) — the elite-seeding invariant ``GA <= engine`` holds on
    every scenario by construction. ``overrides`` patch individual
    :class:`GAParams` fields (``ga_schedule(g, m, generations=8)``)."""
    from ..core.registry import get_scheduler

    par = params or GAParams()
    if overrides:
        par = replace(par, **overrides)
    base_sched = get_scheduler(baseline)(graph, machine)
    if len(graph.tasks) == 0:
        return base_sched
    elite = encode(graph, base_sched)
    if releases:
        # the heuristic scheduled without the floors; keep its *mapping*
        # as the elite but re-decode it under the floors so the fallback
        # candidate also respects the requested release semantics
        base_sched = decode(graph, machine, elite, releases=releases)
    vec, _ = ga_search(graph, machine, seed=seed, params=par,
                       elites=[elite], releases=releases)
    cand = decode(graph, machine, vec, releases=releases)
    return cand if cand.makespan() <= base_sched.makespan() else base_sched
