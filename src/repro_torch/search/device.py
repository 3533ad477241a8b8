"""Device-resident GA: decode → lower → relax → select on one device.

The host GA (``search/ga.py``) batches *fitness*, but every generation
still round-trips through Python: B candidates are decoded one at a
time on a Timeline, lowered one at a time to ScenarioArrays, and the
selection/crossover/mutation loop runs on host NumPy. This module keeps
the whole generation on one device (the card by default):

* **Pre-lowering** (:func:`device_inputs`). One
  :func:`repro_torch.core.lowering.population_arrays` call resolves the
  (graph, machine) pair to fixed-shape topo-ordered arrays — exec
  times, padded predecessor slots, comm matrices — linted and uploaded
  once and reused by *every* generation.
* **Decode as gathers.** A population ``genes`` (B, n_tasks) turns
  into per-subtask cores, durations and per-edge (latency, vol/bw)
  lags with tensor gathers — no per-candidate loop.
* **Fitness** (:func:`population_fitness_device`). ``method="kernel"``
  (the default on the card) runs the recurrence as ``S`` synchronous
  max-plus sweeps through the ``sim_relax_pop`` kernel
  (``kernels/csrc/sim_relax_pop.cu``; its plain version for CPU
  tensors). ``method="scan"`` (the default on the CPU) is the
  append-only list decode written out: a loop over topological slots,
  vectorised over candidates, carrying the end vector and the per-core
  frontier. The graph is acyclic, so both reach the same fixpoint bit
  for bit (the NumPy oracle ``kernels.ref.pop_relax_np`` pins both).
* **Selection on the device** (:func:`ga_search_device`). Tournament +
  elite-bias parent draws, uniform crossover and gene resampling are
  tensor ops drawn from one ``torch.Generator`` on the population's
  device, seeded from ``seed`` — no host RNG anywhere in the loop.

Semantics: the device decoder is **append-only** — it does not backfill
earliest gaps like the host ``decode`` (gap search is a data-dependent
Timeline walk), so device fitness can exceed host fitness where a gap
would have helped; ``decode(gap_fill=False)`` is the host-side oracle
of exactly this semantics. The ``ga <= engine`` invariant is untouched:
``ga_schedule`` re-decodes the evolved winner with the full gap-filling
host decoder and returns the better of it and the heuristic baseline.

``frozen`` placements (mid-flight recovery) stay on the host path —
``GAParams(device=True)`` falls back automatically there.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..analysis.ir_lint import lint_population_arrays
from ..core import lowering
from ..core.machine import MachineModel
from ..core.mpaha import AppGraph
from ..core.sim_engine import check_backend
from ..kernels import ops
from .local import FITNESS_DEVICE, hill_climb_device


class DevicePopulation(NamedTuple):
    """Device view of :class:`repro_torch.core.lowering.PopulationArrays`
    (+ release floors), float32, in topo-position coordinates, every
    tensor on one device. Index tensors are int64 (torch's gather
    type)."""

    topo_gene: torch.Tensor         # (S,)   gene slot per topo pos
    exec_core: torch.Tensor         # (S, C) f32
    pred_pos: torch.Tensor          # (S, P) pred topo pos, S pad
    pred_gene: torch.Tensor         # (S, P) pred's gene slot
    pred_vol: torch.Tensor          # (S, P) f32 — edge volume, 0 pad
    pred_pad: torch.Tensor          # (S, P) bool — True at padding
    lat: torch.Tensor               # (C, C) f32
    bw: torch.Tensor                # (C, C) f32
    release: torch.Tensor           # (S,)   f32 — topo-permuted floors

    @property
    def n_subtasks(self) -> int:
        return self.topo_gene.shape[0]

    @property
    def n_cores(self) -> int:
        return self.lat.shape[0]

    @property
    def device(self) -> torch.device:
        return self.lat.device


def device_inputs(graph: AppGraph, machine: MachineModel, *,
                  releases: dict[int, float] | None = None,
                  device: str | torch.device = "cuda") -> DevicePopulation:
    """Lower once, search forever: the per-(graph, machine) constants of
    every generation, uploaded to ``device``. ``releases`` (sid -> floor)
    folds into a per-subtask floor vector like the host lowering."""
    pa = lowering.population_arrays(graph, machine)
    # prove the decode-gather contracts (topo permutation, pred-pos
    # bounds) once per (graph, machine) — every generation gathers
    # through these arrays blindly for every candidate after
    lint_population_arrays(pa)
    rel = np.zeros(pa.n_subtasks, np.float32)
    if releases:
        for sid, t in releases.items():
            if not 0 <= sid < pa.n_subtasks:
                raise ValueError(f"release for unknown subtask {sid} "
                                 f"(graph has {pa.n_subtasks})")
            rel[sid] = t
        rel = rel[pa.topo_sid]

    def up(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    return DevicePopulation(
        topo_gene=up(pa.gene, torch.int64),
        exec_core=up(pa.exec_core, torch.float32),
        pred_pos=up(pa.pred_pos, torch.int64),
        pred_gene=up(pa.pred_gene, torch.int64),
        pred_vol=up(pa.pred_vol, torch.float32),
        pred_pad=up(pa.pred_pos == pa.n_subtasks, torch.bool),
        lat=up(pa.lat, torch.float32),
        bw=up(pa.bw, torch.float32),
        release=up(rel, torch.float32),
    )


# ---------------------------------------------------------------------------
# decode: genes -> cores / durations / per-edge lags, all gathers
# ---------------------------------------------------------------------------

def _decode_common(inp: DevicePopulation, genes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """(core, duration, lag_lat, lag_volbw) of a population — (B, S) and
    (B, S, P), f32. Volume-free edges arrive instantly (the simulator's
    edge rule); pads carry ``-inf`` so they never win the readiness max."""
    genes = genes.long()
    b = genes.shape[0]
    s, p = inp.pred_pos.shape
    core = genes[:, inp.topo_gene]                                 # (B, S)
    dur = inp.exec_core[torch.arange(s, device=genes.device)[None, :],
                        core]                                      # (B, S)
    src = genes[:, inp.pred_gene.reshape(-1)].reshape(b, s, p)     # (B, S, P)
    dst = core[:, :, None]
    has_comm = ~inp.pred_pad & (inp.pred_vol > 0.0)
    lag_lat = torch.where(inp.pred_pad, -torch.inf,
                          torch.where(has_comm, inp.lat[src, dst], 0.0))
    lag_volbw = torch.where(inp.pred_pad, -torch.inf,
                            torch.where(has_comm,
                                        inp.pred_vol / inp.bw[src, dst], 0.0))
    return core, dur, lag_lat, lag_volbw


def _prev_on_core(core: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(B, S) topo position of the previous same-core subtask (the
    in-order edge), ``sentinel`` where none — per candidate, via one
    *stable* argsort grouping topo positions by core (an unstable sort
    would link a subtask to a later one: wrong but plausible fitness)."""
    b = core.shape[0]
    order = torch.argsort(core, dim=1, stable=True)   # topo order per core
    sorted_core = torch.gather(core, 1, order)
    same = sorted_core[:, 1:] == sorted_core[:, :-1]
    prev_sorted = torch.cat(
        [torch.full((b, 1), sentinel, dtype=order.dtype, device=core.device),
         torch.where(same, order[:, :-1], sentinel)], dim=1)
    return torch.zeros_like(order).scatter_(1, order, prev_sorted)


def population_gather_inputs(
        inp: DevicePopulation, genes: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor, torch.Tensor]:
    """(pred, lat, volbw, duration, release) in the population-kernel
    gather shape — the device decode resolved to ``sim_relax_pop``
    inputs (int32 ``pred``, float32 rest, contiguous), the in-order core
    edge appended as a zero-lag column."""
    s = inp.n_subtasks
    b = genes.shape[0]
    core, dur, lag_lat, lag_volbw = _decode_common(inp, genes)
    prev = _prev_on_core(core, s)[:, :, None]
    inorder = torch.where(prev < s, 0.0, -torch.inf)
    pred = torch.cat([inp.pred_pos[None].expand(b, s, inp.pred_pos.shape[1]),
                      prev], dim=2).to(torch.int32)
    lat = torch.cat([lag_lat, inorder], dim=2)
    volbw = torch.cat([lag_volbw, inorder], dim=2)
    rel = inp.release[None].expand(b, s).contiguous()
    return pred, lat, volbw, dur.contiguous(), rel


def population_ends(inp: DevicePopulation, genes) -> torch.Tensor:
    """(B, S) finish times (topo coordinates, f32) of a whole population
    — the scan path: the append-only list decode, one topological slot
    at a time for every candidate at once. The carry is the (B, S+1) end
    buffer (slot S = sentinel 0) plus the (B, C) per-core frontier — the
    in-order execution edge without materialising ``prev``. The plain
    version of :func:`population_ends_kernel`."""
    core, dur, lag_lat, lag_volbw = _decode_common(inp, genes)
    b, s = core.shape
    dev = core.device
    ends = torch.zeros((b, s + 1), dtype=torch.float32, device=dev)
    frontier = torch.zeros((b, inp.n_cores), dtype=torch.float32,
                           device=dev)
    rows = torch.arange(b, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for pos in range(s):
        cr = core[:, pos]
        ready = ((ends[:, inp.pred_pos[pos]] + lag_lat[:, pos])
                 + lag_volbw[:, pos]).amax(dim=1)
        ready = torch.maximum(torch.maximum(ready, inp.release[pos]),
                              frontier[rows, cr])
        e = dur[:, pos] + torch.maximum(ready, zero)
        ends[:, pos] = e
        frontier[rows, cr] = e
    return ends[:, :s]


def population_ends_kernel(inp: DevicePopulation, genes) -> torch.Tensor:
    """(B, S) finish times via the population-axis kernel
    (``ops.sim_relax_pop``): S synchronous max-plus sweeps reach the same
    acyclic fixpoint as the scan, bit for bit."""
    return ops.sim_relax_pop(*population_gather_inputs(inp, genes),
                             n_steps=inp.n_subtasks)


def population_fitness_device(inp: DevicePopulation, genes: torch.Tensor,
                              *, method: str = "scan") -> torch.Tensor:
    """(B,) makespans of a population — max finish time per candidate."""
    if method not in ("scan", "kernel"):
        raise ValueError(f"unknown fitness method {method!r} "
                         "(have 'scan', 'kernel')")
    if inp.n_subtasks == 0:
        return torch.zeros(genes.shape[0], dtype=torch.float32,
                           device=genes.device)
    ends = (population_ends_kernel if method == "kernel"
            else population_ends)(inp, genes)
    return ends.amax(dim=1)


# ---------------------------------------------------------------------------
# one generation: select -> crossover -> mutate -> evaluate
# ---------------------------------------------------------------------------

def _generation(inp: DevicePopulation, gen: torch.Generator,
                pop: torch.Tensor, fit: torch.Tensor, *,
                n_cores: int, elite: int, tournament: int,
                elite_bias: float, p_mut: float, method: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(new_pop, new_fit): the full bias-elitist generation as tensor
    ops. Selection is tournament-of-``k`` by fitness gather; a
    ``elite_bias`` fraction of first parents comes from the sorted
    elite pool; the top ``elite`` rows survive unchanged."""
    b, t = pop.shape
    dev = pop.device
    order = torch.argsort(fit, stable=True)
    pop, fit = pop[order], fit[order]
    rows = torch.arange(b, device=dev)

    def draw(high, shape, dtype=torch.int64):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=dtype)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev)

    ta = draw(b, (b, tournament))
    a = ta[rows, fit[ta].argmin(dim=1)]
    use_elite = uniform((b,)) < elite_bias
    a = torch.where(use_elite, draw(max(elite, 1), (b,)), a)
    tb = draw(b, (b, tournament))
    bb = tb[rows, fit[tb].argmin(dim=1)]
    cross = uniform((b, t)) < 0.5
    child = torch.where(cross, pop[a], pop[bb])
    mut = uniform((b, t)) < p_mut
    child = torch.where(mut, draw(n_cores, (b, t), pop.dtype), child)
    if elite:
        child[:elite] = pop[:elite]
    return child, population_fitness_device(inp, child, method=method)


def generation_step(params: Any, *, n_tasks: int, n_cores: int,
                    method: str = "scan") -> Callable:
    """The ``(inp, generator, pop, fit) -> (pop, fit)`` generation step
    :func:`ga_search_device` iterates — exposed so a benchmark can time
    one device generation in isolation."""
    p_mut = params.p_mutation if params.p_mutation is not None \
        else max(1.0 / max(n_tasks, 1), 0.02)
    return functools.partial(
        _generation, n_cores=n_cores, elite=params.elite,
        tournament=params.tournament, elite_bias=params.elite_bias,
        p_mut=p_mut, method=method)


def ga_search_device(graph: AppGraph, machine: MachineModel, *,
                     seed: int = 0, params=None,
                     elites: list[np.ndarray] | None = None,
                     releases: dict[int, float] | None = None,
                     method: str | None = None
                     ) -> tuple[np.ndarray, float]:
    """Device-resident twin of :func:`repro_torch.search.ga.ga_search`:
    returns ``(best_vector, best_fitness)`` with the fitness under the
    append-only device semantics (float32). ``params.backend`` picks the
    device: ``"cuda"`` the card, ``"torch"`` the CPU. Deterministic under
    ``seed`` — every draw comes from one ``torch.Generator`` on that
    device, so reruns reproduce bit-identically. ``method`` picks the
    fitness path: ``"kernel"`` (``sim_relax_pop`` sweeps, default on the
    card) or ``"scan"`` (default on the CPU)."""
    from .ga import GAParams

    par = params or GAParams(device=True)
    device = check_backend(par.backend, FITNESS_DEVICE[par.backend])
    graph.finalize()
    n_tasks = len(graph.tasks)
    n_cores = machine.n_cores
    if method is None:
        method = "kernel" if device.type == "cuda" else "scan"
    inp = device_inputs(graph, machine, releases=releases, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pop = torch.randint(0, max(n_cores, 1), (par.pop_size, n_tasks),
                        generator=gen, device=device, dtype=torch.int32)
    for i, e in enumerate((elites or [])[:par.pop_size]):
        pop[i] = torch.as_tensor(np.asarray(e, np.int32), device=device)

    fitness = functools.partial(population_fitness_device, method=method)
    step = generation_step(par, n_tasks=n_tasks, n_cores=n_cores,
                           method=method)
    fit = fitness(inp, pop)
    for _ in range(par.generations):
        pop, fit = step(inp, gen, pop, fit)

    best = int(torch.argmin(fit))
    vec = pop[best].cpu().numpy().astype(np.int32)
    val = float(fit[best])
    if par.refine_rounds > 0 and n_tasks > 0 and n_cores > 1:
        vec, val = hill_climb_device(fitness, inp, vec, val, generator=gen,
                                     rounds=par.refine_rounds,
                                     moves=par.refine_moves,
                                     n_cores=n_cores)
    return vec, val
