"""Run a registered scheduler over the lowered model graph and apply the
placement back to the runtime.

``place_pipeline`` searches a stage->device assignment with any
task-coherent entry of ``SCHEDULERS`` (``engine`` / ``amtha`` / ``ga``)
and returns a :class:`PipelinePlan` whose predicted makespan is **never
worse than the ``plan_stages`` heuristic**: the heuristic's contiguous
identity assignment is always evaluated as a candidate (and seeds the
GA's elite pool via the engine baseline), and the best vector wins —
the same best-of construction ``search/ga.ga_schedule`` uses.

Application back to the executable stack:

* ``stage_mesh`` turns ``plan.stage_to_device`` into the ``pod``-axis
  :class:`~torch.distributed.device_mesh.DeviceMesh`
  ``runtime.pipeline.make_pipelined_forward`` consumes — the mesh's rank
  order IS the assignment: the rank at coordinate ``s`` runs stage
  ``s``'s layers (``runtime.pipeline.stage_layer_range``), so they land
  on the searched device, and ``gpipe`` takes each stage's neighbours
  from the mesh's own ranks along the axis;
* ``place_moe_experts`` maps MoE experts through the fan-out/fan-in
  graph and emits the equal-group expert permutation that
  ``sharding.partition.permute_expert_params`` applies to the weight
  tree (the expert axis shards contiguously over ``model``, so the
  permutation is the expert->shard layout).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..configs import ARCHS, ModelConfig
from ..core.machine import MachineModel, h100_node
from ..core.mpaha import AppGraph
from ..core.registry import scheduler_entry
from ..core.schedule import validate
from ..search.encoding import decode, encode
from .costs import UnitCosts, unit_costs
from .graph import default_stages, moe_graph, pipeline_graph


def resolve_config(cfg_or_name) -> ModelConfig:
    if isinstance(cfg_or_name, ModelConfig):
        return cfg_or_name
    name = str(cfg_or_name).replace("_", "-")
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {cfg_or_name!r} (have {sorted(ARCHS)})")


def _run_scheduler(name: str, graph: AppGraph, machine: MachineModel,
                   seed: int, sched_kwargs: dict | None = None):
    entry = scheduler_entry(name)
    if not entry.task_coherent:
        raise ValueError(f"scheduler {name!r} is not task-coherent; "
                         "stage/expert placement needs whole-task mapping")
    if name == "ga":
        return entry.fn(graph, machine, seed=seed, **(sched_kwargs or {}))
    return entry.fn(graph, machine, **(sched_kwargs or {}))


# ---------------------------------------------------------------------------
# pipeline stage placement
# ---------------------------------------------------------------------------

@dataclass
class PipelinePlan:
    arch: str
    scheduler: str
    n_stages: int
    n_micro: int
    stage_to_device: list[int]
    t_autoplaced: float               # predicted makespan of the winner
    t_heuristic: float                # plan_stages contiguous identity
    makespans: dict[str, float] = field(default_factory=dict)
    chosen: str = ""
    repaired: bool = False            # duplicates reassigned for execution
    costs: UnitCosts | None = None
    graph: AppGraph | None = None
    machine: MachineModel | None = None

    @property
    def gain_pct(self) -> float:
        return 100.0 * (1.0 - self.t_autoplaced / self.t_heuristic) \
            if self.t_heuristic else 0.0

    def report(self) -> dict:
        return {"arch": self.arch, "scheduler": self.scheduler,
                "machine": self.machine.name if self.machine else "?",
                "n_stages": self.n_stages, "n_micro": self.n_micro,
                "stage_to_device": list(map(int, self.stage_to_device)),
                "chosen": self.chosen, "repaired": self.repaired,
                "t_heuristic": self.t_heuristic,
                "t_autoplaced": self.t_autoplaced,
                "gain_pct": round(self.gain_pct, 2),
                **{f"t_{k}": v for k, v in self.makespans.items()}}


def _bijective_repair(vec: np.ndarray, machine: MachineModel) -> np.ndarray:
    """Executable pipelines need one device per stage. Keep each first
    claim; move later duplicate stages to the free core with the cheapest
    link from the previous stage's core (deterministic)."""
    out = vec.copy()
    used: set[int] = set()
    for s in range(len(out)):
        c = int(out[s])
        if c not in used:
            used.add(c)
            continue
        free = [d for d in range(machine.n_cores) if d not in used]
        prev = int(out[s - 1]) if s else c
        c = min(free, key=lambda d: (machine.comm_time(1.0, prev, d), d))
        out[s] = c
        used.add(c)
    return out


def place_pipeline(cfg_or_name, machine: MachineModel | None = None, *,
                   n_stages: int | None = None, n_micro: int = 8,
                   seq: int = 1024, micro_batch: int = 1,
                   scheduler: str = "engine", source: str = "analytic",
                   seed: int = 0, executable: bool = True,
                   sched_kwargs: dict | None = None) -> PipelinePlan:
    """AMTHA (or any registered task-coherent scheduler) places the
    model's pipeline stages on ``machine``'s devices.

    Candidates evaluated under one cost model (the decoded as-placed
    makespan of ``search/encoding.decode``): the ``plan_stages``-style
    contiguous identity assignment and the searched placement; the best
    wins, so ``t_autoplaced <= t_heuristic`` by construction. With
    ``executable=True`` the winning vector is repaired to a stage->device
    *injection* (an executable GPipe layout); the repair is re-scored and
    the reported ``t_autoplaced`` stays the executable vector's."""
    cfg = resolve_config(cfg_or_name)
    machine = machine or h100_node(2, 8)
    costs = unit_costs(cfg, seq=seq, micro_batch=micro_batch, source=source)
    if n_stages is None:
        n_stages = default_stages(costs.n_units, machine.n_cores)
    graph = pipeline_graph(costs, machine, n_stages=n_stages,
                           n_micro=n_micro)

    identity = np.arange(n_stages, dtype=np.int32)
    makespans = {"heuristic": decode(graph, machine, identity).makespan()}

    searched = _run_scheduler(scheduler, graph, machine, seed, sched_kwargs)
    validate(searched.to_schedule() if hasattr(searched, "to_schedule")
             else searched, graph, machine)
    searched_vec = encode(graph, searched)
    makespans[scheduler] = decode(graph, machine, searched_vec).makespan()

    candidates = {"heuristic": identity, scheduler: searched_vec}
    if executable:
        for name, vec in list(candidates.items()):
            fixed = _bijective_repair(vec, machine)
            if not np.array_equal(fixed, vec):
                candidates[name] = fixed
                makespans[name] = decode(graph, machine, fixed).makespan()
    chosen = min(makespans, key=lambda k: (makespans[k], k != "heuristic"))
    best_vec = candidates[chosen]

    return PipelinePlan(
        arch=cfg.name, scheduler=scheduler, n_stages=n_stages,
        n_micro=n_micro, stage_to_device=[int(c) for c in best_vec],
        t_autoplaced=makespans[chosen], t_heuristic=makespans["heuristic"],
        makespans=makespans, chosen=chosen,
        repaired=bool(not np.array_equal(best_vec,
                                         candidates.get(chosen, best_vec))),
        costs=costs, graph=graph, machine=machine)


def place(arch, scheduler: str = "ga", **kwargs) -> PipelinePlan:
    """The flagship entry point: ``autoplace.place("gemma2_2b",
    scheduler="ga")`` — AMTHA/GA places the model's own pipeline. The
    GA's fitness runs on the card unless ``sched_kwargs`` gives
    ``{"params": GAParams(backend="numpy")}`` (or ``"torch"``)."""
    return place_pipeline(arch, scheduler=scheduler, **kwargs)


def stage_mesh(stage_to_device: list[int], *, axis_name: str = "pod",
               device_type: str | None = None):
    """The searched assignment as an executable mesh: position ``s`` of
    the ``pod`` axis holds rank ``stage_to_device[s]`` of the default
    process group (one rank a device), so ``make_pipelined_forward``
    runs stage ``s`` exactly where the scheduler put it. ``device_type``
    as :func:`repro_torch.launch.mesh.make_mesh`'s (the card unless
    ``"cpu"`` is asked for); every rank of the world calls it."""
    from ..launch.mesh import make_mesh
    assert len(set(stage_to_device)) == len(stage_to_device), \
        "stage_to_device must be injective for an executable pipeline " \
        "(see PipelinePlan.repaired)"
    return make_mesh((len(stage_to_device),), (axis_name,),
                     device_type=device_type, ranks=list(stage_to_device))


# ---------------------------------------------------------------------------
# MoE expert placement
# ---------------------------------------------------------------------------

@dataclass
class ExpertPlan:
    arch: str
    scheduler: str
    expert_to_device: list[int]
    permutation: list[int]            # weight reorder: new position -> expert
    t_autoplaced: float
    t_roundrobin: float
    makespans: dict[str, float] = field(default_factory=dict)

    @property
    def gain_pct(self) -> float:
        return 100.0 * (1.0 - self.t_autoplaced / self.t_roundrobin) \
            if self.t_roundrobin else 0.0


def place_moe_experts(cfg_or_name, loads_tokens, machine=None, *,
                      n_devices: int | None = None,
                      scheduler: str = "engine", seed: int = 0
                      ) -> ExpertPlan:
    """Scheduler-searched expert->device layout for one MoE layer,
    capacity-balanced to equal groups (the contiguously sharded expert
    axis needs ``E / n_devices`` experts per device). Apply with
    ``sharding.partition.permute_expert_params(model,
    plan.permutation)``."""
    cfg = resolve_config(cfg_or_name)
    e = cfg.n_experts
    assert e, f"{cfg.name} has no experts"
    if machine is None:
        machine = h100_node(1, n_devices or 8)
    n_dev = machine.n_cores
    per_dev = e // n_dev
    assert per_dev * n_dev == e, "experts must tile devices"

    graph = moe_graph(cfg, machine, list(loads_tokens))
    sched = _run_scheduler(scheduler, graph, machine, seed)
    raw = [sched.core_of(graph.tasks[1 + i][0]) for i in range(e)]

    # capacity-balance: walk experts by decreasing load, honor the
    # scheduler's choice while its device has room, else spill to the
    # least-loaded device with space (deterministic tie-break by index)
    order = sorted(range(e), key=lambda i: (-loads_tokens[i], i))
    count = [0] * n_dev
    load = [0.0] * n_dev
    assign = [-1] * e
    for i in order:
        d = raw[i]
        if count[d] >= per_dev:
            d = min((x for x in range(n_dev) if count[x] < per_dev),
                    key=lambda x: (load[x], x))
        assign[i] = d
        count[d] += 1
        load[d] += loads_tokens[i]
    perm = sorted(range(e), key=lambda i: (assign[i], i))

    # predicted makespans under the shared graph cost model
    def vec_for(a):
        return np.asarray([0] + list(a) + [0], np.int32)
    t_auto = decode(graph, machine, vec_for(assign)).makespan()
    rr = [i % n_dev for i in range(e)]
    t_rr = decode(graph, machine, vec_for(rr)).makespan()
    if t_rr < t_auto:                 # balance fallback: never worse
        assign, t_auto = rr, t_rr
        perm = sorted(range(e), key=lambda i: (assign[i], i))
    return ExpertPlan(cfg.name, scheduler, assign, perm, t_auto, t_rr,
                      {"autoplace": t_auto, "round_robin": t_rr})
