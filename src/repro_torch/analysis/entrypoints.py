"""Manifest of every hot entry point the port's tracecheck must prove.

The analyzer (:mod:`repro_torch.analysis.tracecheck`) is only as good as
its coverage: a hot path that never lands in this manifest is a hot path
nobody checks. So registration is *explicit* — each :class:`EntryPoint`
names one callable of the port (a kernel's guarded wrapper, the device
GA's generation step, the admission scorer) and knows how to build
representative arguments per suite size on a given device, mirroring the
8/64/256-core suites of ``repro_torch.analysis.verify``:

* ``8core`` — ``dell_poweredge_1950``, 3 synthetic apps of 8–12 tasks;
* ``64core`` — ``hp_bl260c``, 2 apps of 20–30 tasks;
* ``256core`` — ``cluster_of_multicores(n_blades=32)``, 2 apps of
  30–40 tasks;
* ``model`` — model-stack shapes.

Every input is made with NumPy from a seed and then put on the device,
so the CPU and the card check the same values. A build returns a
:class:`Built`: the callable, its arguments, a same-shape/different-value
argument *sweep* for the retrace detector, and optionally a
:class:`CostRef` — roofline terms the counted FLOPs must agree with.

The reference's manifest also holds ``runtime.pipelined_forward`` and
two ``autoplace.unit[...]`` entries; they need ``sharding/``,
``runtime/pipeline.py`` and ``autoplace/``, which the port does not have
yet, and join this manifest with them.

Adding a new hot entry point to the port? Register it here (or via
:func:`register_entrypoint` next to its definition) in the same change
— ``python -m repro_torch.analysis.tracecheck --quick`` walks this
manifest and nothing else.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["Built", "CostRef", "EntryPoint", "MANIFEST", "SUITES",
           "manifest", "register_entrypoint"]

#: suite names understood by the builders below
SUITES = ("8core", "64core", "256core", "model")


@dataclass(frozen=True)
class CostRef:
    """Roofline reference terms for the cost cross-check pass: the
    counted matmul FLOPs over ``flops`` must land inside
    ``flops_bounds``. ``hbm_bytes`` is kept beside it for the record
    (no counted byte term exists in eager PyTorch)."""

    flops: float
    hbm_bytes: float
    flops_bounds: tuple[float, float] = (0.85, 1.15)
    source: str = "closed form"


@dataclass
class Built:
    """One runnable instantiation of an entry point.

    ``fn(*args)`` runs it; ``sweep`` holds extra argument tuples of
    identical shapes and dtypes but different values: a callable that
    keeps its host control flow off the data runs the same ops on every
    one of them."""

    fn: Callable
    args: tuple
    sweep: tuple = ()
    cost_ref: Optional[CostRef] = None


@dataclass(frozen=True)
class EntryPoint:
    """A registered entry point: name + per-suite builder
    ``build(suite, device)``.

    ``const_bytes_limit`` caps the size of host data one call may put on
    the device or wrap as a tensor (the "closed over the population" bug
    class: correct numbers, one upload per call); ``host_syncs`` is the
    number of host read-backs per call the entry is built to make (its
    result leaving the card, a guard that reads an index range back);
    ``allow_f64`` / ``allow_upcast`` relax the dtype pass for entries
    whose promotion is deliberate."""

    name: str
    build: Callable[[str, torch.device], Built]
    suites: tuple[str, ...] = ("8core",)
    const_bytes_limit: int = 64 * 1024
    host_syncs: int = 0
    allow_f64: bool = False
    allow_upcast: bool = False
    doc: str = ""


# ---------------------------------------------------------------------------
# suite builders (mirror analysis.verify's sweep)
# ---------------------------------------------------------------------------

def _suite_workload(suite: str, seed: int = 0):
    """(machine, graphs) of one scheduling suite."""
    from ..core import (SynthParams, cluster_of_multicores,
                        dell_poweredge_1950, generate_app, hp_bl260c)

    def apps(lo, hi, n, base):
        return [generate_app(SynthParams(n_tasks=(lo, hi)), seed=base + i)
                for i in range(n)]

    if suite == "8core":
        return dell_poweredge_1950(), apps(8, 12, 3, seed)
    if suite == "64core":
        return hp_bl260c(), apps(20, 30, 2, seed + 10)
    if suite == "256core":
        return cluster_of_multicores(n_blades=32), apps(30, 40, 2,
                                                        seed + 20)
    raise ValueError(f"unknown scheduling suite {suite!r} "
                     f"(have {SUITES[:3]})")


def _scheduled_batch(suite: str):
    """A lowered ScenarioBatch of engine-scheduled suite apps."""
    from ..core import batch_scenarios, get_scheduler, lower_scenario
    machine, graphs = _suite_workload(suite)
    sched = get_scheduler("engine")
    scenarios = [lower_scenario(g, machine, sched(g, machine))
                 for g in graphs]
    return machine, graphs, batch_scenarios(scenarios)


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in arrays)


# ---------------------------------------------------------------------------
# entry builders
# ---------------------------------------------------------------------------

def _build_generation_step(suite: str, device: torch.device) -> Built:
    from ..search.device import (device_inputs, generation_step,
                                 population_fitness_device)
    from ..search.ga import GAParams
    machine, graphs = _suite_workload(suite)
    graph = graphs[0]
    params = GAParams(pop_size=16, generations=2, device=True)
    inp = device_inputs(graph, machine, device=device)
    n_tasks = len(graph.tasks)
    method = "kernel" if device.type == "cuda" else "scan"
    step = generation_step(params, n_tasks=n_tasks,
                           n_cores=machine.n_cores, method=method)

    def pop_at(seed):
        rng = np.random.default_rng(seed)
        (pop,) = _on(device, rng.integers(0, machine.n_cores,
                                          (params.pop_size, n_tasks),
                                          dtype=np.int32))
        gen = torch.Generator(device=device).manual_seed(seed)
        return (inp, gen, pop,
                population_fitness_device(inp, pop, method=method))

    return Built(fn=step, args=pop_at(0), sweep=(pop_at(1), pop_at(2)))


def _build_sim_relax_pop(suite: str, device: torch.device) -> Built:
    from ..core.sim_engine import _jitter_durations, _pop_gather_inputs
    from ..kernels import ops
    _, _, batch = _scheduled_batch(suite)
    pred, lat, volbw = _pop_gather_inputs(batch)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    fn = functools.partial(ops.sim_relax_pop, n_steps=batch.depth)
    base = _on(device, pred, f32(lat), f32(volbw), f32(batch.duration),
               f32(batch.release))
    sweep = tuple(
        _on(device, pred, f32(lat), f32(volbw),
            f32(_jitter_durations(batch, 0.2,
                                  range(s, s + batch.n_scenarios))),
            f32(batch.release))
        for s in (1, 7))
    return Built(fn=fn, args=base, sweep=sweep)


def _build_sched_score(suite: str, device: torch.device) -> Built:
    from ..core.lowering import drain_matrix
    from ..kernels import ops
    machine, graphs = _suite_workload(suite)
    drain = np.asarray(drain_matrix(graphs, machine), np.float32)
    a, c = drain.shape
    frontiers = np.zeros(c, np.float32)
    release = np.zeros(a, np.float32)
    sweep = (_on(device, drain * 1.5, frontiers + 3.0, release + 1.0),
             _on(device, drain + 0.25, frontiers + 7.0, release))
    return Built(fn=ops.sched_score,
                 args=_on(device, drain, frontiers, release), sweep=sweep)


def _build_admission_score(suite: str, device: torch.device) -> Built:
    """The batched admission scorer itself,
    ``online.policies.BatchedPolicy.kernel_scores``: a drain matrix off
    the shared scenario IR, live cluster frontiers, per-app release
    floors, packed and uploaded once, one fused launch, the A minima read
    back. The policy is warmed once, so its staging buffer exists, as in
    every batch after a policy's first."""
    from ..online import (ArrivalParams, BatchedPolicy, OnlineAMTHA,
                          generate_workload)
    machine, _ = _suite_workload(suite)
    eng = OnlineAMTHA(machine)
    arrivals = generate_workload(ArrivalParams(), n_apps=6, seed=0)
    for a in arrivals[:3]:
        eng.admit(a)
    batch = arrivals[3:]
    policy = BatchedPolicy(k=len(batch), scorer="kernel", device=device)
    now = batch[-1].t_arrival
    policy.kernel_scores(batch, eng, now)
    return Built(fn=policy.kernel_scores, args=(batch, eng, now),
                 sweep=((batch, eng, now + 5.0), (batch, eng, now + 2.5)))


def _build_flash_attention(suite: str, device: torch.device) -> Built:
    from ..kernels import ops
    b, s, hq, hkv, d = 1, 128, 4, 2, 64

    def at(seed):
        rng = np.random.default_rng(seed)
        return _on(device, *(rng.standard_normal(shape, np.float32)
                             for shape in ((b, s, hq, d), (b, s, hkv, d),
                                           (b, s, hkv, d))))

    def fn(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    return Built(fn=fn, args=at(0), sweep=(at(1),))


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

_BUILTIN: tuple[EntryPoint, ...] = (
    EntryPoint(
        "search.generation_step", _build_generation_step,
        suites=("8core", "64core"), host_syncs=2,
        doc="device-GA generation (select/crossover/mutate/eval); on the "
            "card its fitness is sim_relax_pop, whose gather-bounds guard "
            "reads the index range back (2 scalars)"),
    EntryPoint(
        "sim.relax_pop", _build_sim_relax_pop,
        suites=("8core", "64core", "256core"), host_syncs=2,
        doc="ops.sim_relax_pop — the kernel of simulate_batch/"
            "simulate_suite(backend='cuda'); 2 scalars of its "
            "gather-bounds guard"),
    EntryPoint(
        "kernels.sched_score", _build_sched_score,
        suites=("8core", "64core"),
        doc="ops.sched_score over an (apps x cores) drain matrix"),
    EntryPoint(
        "online.admission_score", _build_admission_score,
        suites=("8core",), host_syncs=1,
        doc="BatchedPolicy.kernel_scores: one upload, one fused "
            "sched_score launch, the A row minima read back"),
    EntryPoint(
        "kernels.flash_attention", _build_flash_attention,
        suites=("model",),
        doc="GQA flash attention wrapper, float32"),
)

_REGISTERED: list[EntryPoint] = []


def register_entrypoint(ep: EntryPoint) -> EntryPoint:
    """Add an entry point to the manifest (for subsystems that define
    their callables after import, or tests planting defect fixtures).
    Returns ``ep`` so it can decorate a module constant."""
    if any(e.name == ep.name for e in manifest()):
        raise ValueError(f"entry point {ep.name!r} already registered")
    _REGISTERED.append(ep)
    return ep


def manifest() -> tuple[EntryPoint, ...]:
    """The full manifest: built-ins + runtime registrations."""
    return _BUILTIN + tuple(_REGISTERED)


#: import-time snapshot (built-ins only) — prefer :func:`manifest`
MANIFEST = _BUILTIN
