"""Manifest of every hot entry point the port's tracecheck must prove.

The analyzer (:mod:`repro_torch.analysis.tracecheck`) is only as good as
its coverage: a hot path that never lands in this manifest is a hot path
nobody checks. So registration is *explicit* — each :class:`EntryPoint`
names one callable of the port (a kernel's guarded wrapper, the device
GA's generation step, the admission scorer, the pipelined forward, a
model's repeat unit) and knows how to build
representative arguments per suite size on a given device, mirroring the
8/64/256-core suites of ``repro_torch.analysis.verify``:

* ``8core`` — ``dell_poweredge_1950``, 3 synthetic apps of 8–12 tasks;
* ``64core`` — ``hp_bl260c``, 2 apps of 20–30 tasks;
* ``256core`` — ``cluster_of_multicores(n_blades=32)``, 2 apps of
  30–40 tasks;
* ``model`` — model-stack shapes (small inputs on the device; full
  ``ARCHS`` entries abstractly, on fake tensors).

Every concrete input is made with NumPy from a seed and then put on the
device, so the CPU and the card check the same values. A build returns a
:class:`Built`: the callable, its arguments, a same-shape/different-value
argument *sweep* for the retrace detector, and optionally a
:class:`CostRef` — roofline terms the counted FLOPs and traffic bytes
must agree with, within its ratio bounds.

The model-stack cost entries (``runtime.pipelined_forward``,
``autoplace.unit[...]``) are *abstract*, as the reference's are: they
are built and called on fake CPU tensors (shapes and dtypes, no
storage, nothing computed) whatever the device, and the pipeline's under
a ``fake`` process group of 4 ranks of its own
(:func:`repro_torch.launch.mesh.fake_world`), torn down after the call.
No 2B-parameter weight is ever allocated for their cost cross-checks.

Adding a new hot entry point to the port? Register it here (or via
:func:`register_entrypoint` next to its definition) in the same change
— ``python -m repro_torch.analysis.tracecheck --quick`` walks this
manifest and nothing else.
"""

from __future__ import annotations

import contextlib
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
    """Roofline reference terms for the cost cross-check pass.

    ``flops``/``hbm_bytes`` come from ``autoplace.costs.unit_costs`` (or
    a closed-form count for the other entries); the counted matmul FLOPs
    over ``flops`` must land inside ``flops_bounds`` and the counted
    traffic proxy (:func:`repro_torch.launch.op_analysis.call_cost`)
    over ``hbm_bytes`` inside ``bytes_bounds``."""

    flops: float
    hbm_bytes: float
    flops_bounds: tuple[float, float] = (0.85, 1.15)
    bytes_bounds: tuple[float, float] = (0.05, 20.0)
    source: str = "closed form"


@dataclass
class Built:
    """One runnable instantiation of an entry point.

    ``fn(*args)`` runs it; ``sweep`` holds extra argument tuples of
    identical shapes and dtypes but different values: a callable that
    keeps its host control flow off the data runs the same ops on every
    one of them. ``abstract``: ``fn`` and ``args`` live on fake CPU
    tensors inside the contexts ``stack`` holds open (a fake tensor
    mode, a fake process group), which the tracecheck closes after its
    passes."""

    fn: Callable
    args: tuple
    sweep: tuple = ()
    cost_ref: Optional[CostRef] = None
    abstract: bool = False
    stack: Optional[contextlib.ExitStack] = None


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


def _reduced_pipeline_cfg():
    from ..configs import ARCHS, reduced
    return reduced(ARCHS["glm4-9b"]).replace(dtype="float32", n_layers=4)


#: the pipeline entry's fake world: 4 ranks, as the reference's CI
#: forces 4 host devices
_PIPELINE_RANKS = 4


def _build_pipelined_forward(suite: str, device: torch.device) -> Built:
    """``make_pipelined_forward`` over as many pipeline stages as a fake
    world of 4 ranks holds, abstract: rank 0's stage on fake CPU
    tensors — the pass suite reads structure and cost, it never runs
    the pipeline."""
    from ..autoplace.costs import unit_costs
    from ..launch.mesh import fake_world, make_mesh
    from ..launch.op_analysis import fake_mode
    from ..models.model import init_params
    from ..runtime.pipeline import make_pipelined_forward
    cfg = _reduced_pipeline_cfg()
    _, n_rep, _, _ = cfg.repeat_structure()
    n_stages = max(s for s in range(1, _PIPELINE_RANKS + 1)
                   if n_rep % s == 0)
    n_micro, bm, seq = 3, 2, 16
    # roofline reference for rank 0's share of the pipeline: the port's
    # gpipe runs a stage only on the ticks where its microbatch is in
    # range (the reference's runs the bubble's ticks too, on don't-care
    # data), so n_micro stage calls of n_rep / n_stages units each, plus
    # the head on every microbatch (2*d*V dots per token; the embedding
    # is a gather, no dot term). The per-unit term is the counted source,
    # as the reference's is its hlo source (the analytic closed form is
    # pinned at full scale and undercounts at these toy dims)
    unit = unit_costs(cfg, seq=seq, micro_batch=bm, source="counted")
    head = 2.0 * bm * seq * cfg.d_model * cfg.vocab
    units_per_stage = n_rep // n_stages
    ref = CostRef(
        flops=n_micro * units_per_stage * unit.flops + n_micro * head,
        hbm_bytes=n_micro * units_per_stage * unit.hbm_bytes,
        flops_bounds=(0.8, 1.25), bytes_bounds=(0.3, 5.0),
        source="autoplace.unit_costs(counted) * n_micro * units a stage "
               "+ n_micro * head (gpipe skips the bubble's ticks; rank 0)")
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(fake_world(_PIPELINE_RANKS))
        mesh = make_mesh((n_stages,), ("pod",), device_type="cpu")
        stack.enter_context(fake_mode())
        model = init_params(cfg, torch.Generator(), "cpu")
        tokens = torch.zeros((n_micro, bm, seq), dtype=torch.int64)
        fwd = make_pipelined_forward(cfg, mesh, n_stages)
    except BaseException:
        stack.close()
        raise
    return Built(fn=fwd, args=(model, tokens), abstract=True,
                 cost_ref=ref, stack=stack)


def _build_autoplace_unit(arch: str) -> Callable[[str, torch.device],
                                                  Built]:
    def build(suite: str, device: torch.device) -> Built:
        """One repeat unit of ``arch`` on fake CPU tensors, exactly as
        ``autoplace.costs.counted_unit_terms`` runs it — the cost pass
        counts its FLOPs and traffic and must land inside the
        analytic-vs-counted ratio bounds ``tests/test_torch_autoplace.py``
        pins."""
        from ..autoplace.costs import unit_call, unit_costs
        from ..configs import ARCHS
        from ..launch.op_analysis import fake_mode
        from ..models.model import DTYPES
        cfg = ARCHS[arch]
        _, _, unit, _ = cfg.repeat_structure()
        seq, micro_batch = 1024, 1
        ana = unit_costs(cfg, seq=seq, micro_batch=micro_batch)
        lo, hi = _UNIT_FLOP_BOUNDS.get(arch, (0.6, 1.4))
        # bytes: the traffic proxy counts every eager op's operands and
        # result, the analytic term only the weight + 4x-activation
        # floor — same order of magnitude is the contract, as the
        # reference's
        ref = CostRef(flops=ana.flops, hbm_bytes=ana.hbm_bytes,
                      flops_bounds=(lo, hi), bytes_bounds=(0.5, 25.0),
                      source="autoplace.unit_costs(analytic)")
        stack = contextlib.ExitStack()
        try:
            stack.enter_context(fake_mode())
            fn, layers = unit_call(cfg, unit, torch.Generator(), "cpu")
            x = torch.zeros((micro_batch, seq, cfg.d_model),
                            dtype=DTYPES[cfg.dtype])
        except BaseException:
            stack.close()
            raise
        return Built(fn=fn, args=(layers, x), abstract=True, cost_ref=ref,
                     stack=stack)
    return build


#: analytic/counted dot-FLOP ratio bounds per arch — the reference's
#: analytic-vs-HLO tolerances, which ``tests/test_torch_autoplace.py``
#: pins for the counted source
_UNIT_FLOP_BOUNDS = {"gemma-2b": (0.85, 1.15), "gemma2-2b": (0.60, 1.20)}


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
    EntryPoint(
        "runtime.pipelined_forward", _build_pipelined_forward,
        suites=("model",),
        doc="gpipe'd LM forward over the pod mesh, reduced glm4-9b; "
            "abstract: rank 0 of a fake world of 4"),
    EntryPoint(
        "autoplace.unit[gemma-2b]", _build_autoplace_unit("gemma-2b"),
        suites=("model",), allow_upcast=True,
        doc="one gemma-2b repeat unit, abstract — cost cross-check vs "
            "the analytic roofline"),
    EntryPoint(
        "autoplace.unit[gemma2-2b]", _build_autoplace_unit("gemma2-2b"),
        suites=("model",), allow_upcast=True,
        doc="one gemma2-2b repeat unit (local/global attn pair), "
            "abstract"),
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
