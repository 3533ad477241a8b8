"""Shared scenario array IR: one lowering from (graph, machine, schedule).

The array engine's exec/comm matrices, the admission scorer's drain
matrix, the array event loop, the batched simulator and the mapping
search's population batches all gather from the IR here:

* :class:`MachineArrays` — ``(C, C)`` comm latency/bandwidth matrices
  resolved from the location hierarchy (same-core entries are
  ``(0, inf)`` so ``lat + vol / bw`` is an exact ``0.0``), plus the
  *shared-level-instance* id per core pair — the contention domain the
  fluid simulator charges transfers against;
* :class:`GraphArrays` — the ``(S, T)`` per-type exec-time matrix and
  CSR predecessor/successor adjacency with edge volumes, in the exact
  order ``AppGraph.finalize`` materialises them (chain edge first, then
  comm edges in insertion order — event and jitter-draw order depend on
  it);
* :class:`ScenarioArrays` — one *scenario* = (graph, machine, schedule
  [, releases]): exec times gathered through ``core_types`` onto cores,
  placement arrays, per-core schedule-order arrays, and per-subtask
  release floors. This is what the array simulator executes;
* :class:`ScenarioBatch` — many scenarios padded to one fixed shape
  ``(B, S, P)`` for the batched relaxation step (``kernels/sim_step.py``
  holds the device form of the same step). Scenarios may mix machines
  and graphs freely — the lowering already resolved everything to
  per-edge lags, so core counts never appear in the batch.

All arrays are frozen (``writeable=False``): consumers share them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .machine import MachineModel
from .mpaha import AppGraph


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


# ---------------------------------------------------------------------------
# machine lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MachineArrays:
    """Per-machine constants, cached on the machine object."""

    n_cores: int
    n_types: int
    core_types: np.ndarray          # (C,)   int32
    lat: np.ndarray                 # (C, C) f64, 0 on the diagonal
    bw: np.ndarray                  # (C, C) f64, inf on the diagonal
    pair_instance: np.ndarray       # (C, C) int32, -1 diag; shared-level id
    inst_level: np.ndarray          # (I,)   int32 — hierarchy depth per id
    inst_lat: np.ndarray            # (I,)   f64
    inst_bw: np.ndarray             # (I,)   f64

    @property
    def n_instances(self) -> int:
        return len(self.inst_level)


def machine_arrays(machine: MachineModel) -> MachineArrays:
    cached = getattr(machine, "_machine_arrays", None)
    if cached is not None and cached.n_cores == machine.n_cores:
        return cached
    n = machine.n_cores
    lat = np.zeros((n, n))
    bw = np.full((n, n), np.inf)
    pair = np.full((n, n), -1, np.int32)
    # instance key exactly as the fluid simulator forms it: the hierarchy
    # depth plus both location prefixes above it (equal for first-differ
    # pairs, kept verbatim for the same-leaf fallback)
    ids: dict[tuple, int] = {}
    inst_level: list[int] = []
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            d = machine.level_index(a, b)
            lvl = machine.levels[d]
            lat[a, b] = lvl.latency
            bw[a, b] = lvl.bandwidth
            key = (d, machine.locations[a][:d], machine.locations[b][:d])
            iid = ids.setdefault(key, len(ids))
            if iid == len(inst_level):
                inst_level.append(d)
            pair[a, b] = iid
    levels = np.asarray(inst_level, np.int32)
    ma = MachineArrays(
        n_cores=n, n_types=machine.n_types,
        core_types=_frozen(np.asarray(machine.core_types, np.int32)),
        lat=_frozen(lat), bw=_frozen(bw), pair_instance=_frozen(pair),
        inst_level=_frozen(levels),
        inst_lat=_frozen(np.array([machine.levels[d].latency for d in levels])),
        inst_bw=_frozen(np.array([machine.levels[d].bandwidth for d in levels])),
    )
    machine._machine_arrays = ma
    return ma


def comm_matrices(machine: MachineModel) -> tuple[np.ndarray, np.ndarray]:
    """(latency, bandwidth) matrices over core pairs — the values
    ``comm_time`` would produce, with same-core entries ``(0, inf)`` so
    ``lat + vol / bw`` short-circuits to an exact ``0.0``."""
    ma = machine_arrays(machine)
    return ma.lat, ma.bw


# ---------------------------------------------------------------------------
# graph lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GraphArrays:
    """Machine-independent arrays of one MPAHA graph."""

    n_subtasks: int
    n_tasks: int
    n_types: int
    exec_type: np.ndarray           # (S, T) f64 — V_i(s, p) of the paper
    task_of: np.ndarray             # (S,)   int32
    pred_ptr: np.ndarray            # (S+1,) int32 — CSR over graph.preds
    pred_sid: np.ndarray            # (E,)   int32
    pred_vol: np.ndarray            # (E,)   f64
    succ_ptr: np.ndarray            # (S+1,) int32 — CSR over graph.succs
    succ_sid: np.ndarray            # (E,)   int32
    succ_vol: np.ndarray            # (E,)   f64

    def preds_of(self, sid: int) -> list[tuple[int, float]]:
        lo, hi = self.pred_ptr[sid], self.pred_ptr[sid + 1]
        return list(zip(self.pred_sid[lo:hi].tolist(),
                        self.pred_vol[lo:hi].tolist()))


def _csr(adj: list[list[tuple[int, float]]]
         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    ptr = np.zeros(len(adj) + 1, np.int32)
    sid, vol = [], []
    for i, row in enumerate(adj):
        ptr[i + 1] = ptr[i] + len(row)
        for s, v in row:
            sid.append(s)
            vol.append(v)
    return (_frozen(ptr), _frozen(np.asarray(sid, np.int32)),
            _frozen(np.asarray(vol, dtype=np.float64)))


def graph_arrays(graph: AppGraph) -> GraphArrays:
    """Lower one graph; cached on the graph, invalidated the same way
    ``finalize`` detects mutation (subtask/edge counts)."""
    fp = (len(graph.subtasks), len(graph.edges))
    cached = getattr(graph, "_graph_arrays", None)
    if cached is not None and cached[0] == fp:
        return cached[1]
    graph.finalize()
    pred_ptr, pred_sid, pred_vol = _csr(graph.preds)
    succ_ptr, succ_sid, succ_vol = _csr(graph.succs)
    ga = GraphArrays(
        n_subtasks=graph.n_subtasks, n_tasks=len(graph.tasks),
        n_types=graph.n_types,
        exec_type=_frozen(np.array([st.times for st in graph.subtasks],
                                   dtype=np.float64).reshape(
                                       graph.n_subtasks, graph.n_types)),
        task_of=_frozen(np.asarray([st.task_id for st in graph.subtasks],
                                   np.int32)),
        pred_ptr=pred_ptr, pred_sid=pred_sid, pred_vol=pred_vol,
        succ_ptr=succ_ptr, succ_sid=succ_sid, succ_vol=succ_vol,
    )
    graph._graph_arrays = (fp, ga)
    return ga


def _exec_core(ga: GraphArrays, ma: MachineArrays) -> np.ndarray:
    """(S, C) exec times gathered through ``core_types``, cached on the
    frozen GraphArrays keyed by the machine's MachineArrays identity —
    every scenario of one (graph, machine) pair (a whole GA population,
    every generation) shares one gather instead of paying O(S·C) each."""
    cached = ga.__dict__.get("_exec_core")
    if cached is None or cached[0] is not ma:
        cached = (ma, _frozen(ga.exec_type[:, ma.core_types]))
        object.__setattr__(ga, "_exec_core", cached)
    return cached[1]


def exec_matrix(graph: AppGraph, machine: MachineModel) -> np.ndarray:
    """(S, C) exec times gathered through ``core_types`` — the §3.3
    chain-walk input of the array engine."""
    return _exec_core(graph_arrays(graph), machine_arrays(machine))


def drain_matrix(graphs: list[AppGraph], machine: MachineModel) -> np.ndarray:
    """(apps × cores) serial drain times — the admission-screening
    scoring input (one per-type work vector per app, gathered onto
    cores)."""
    ma = machine_arrays(machine)
    per_type = np.stack([graph_arrays(g).exec_type.sum(axis=0)
                         for g in graphs])
    return per_type[:, ma.core_types]


# ---------------------------------------------------------------------------
# fault lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultArrays:
    """A fault script resolved against one machine.

    ``fail_t`` is the per-core fail instant (``inf`` = never dies);
    ``slow`` holds per-core ``(t, factor)`` slowdown steps and
    ``degrade`` per-unordered-pair ``(t, factor)`` link steps, both in
    script order — factors compose multiplicatively in that order, so
    keeping the order is what makes every simulator's float products
    bit-identical."""

    n_cores: int
    fail_t: np.ndarray              # (C,) f64, inf = never
    slow: tuple[tuple[tuple[float, float], ...], ...]       # per core
    degrade: dict[tuple[int, int], tuple[tuple[float, float], ...]]

    @property
    def max_slow_events(self) -> int:
        return max((len(s) for s in self.slow), default=0)

    @property
    def max_degrade_events(self) -> int:
        return max((len(d) for d in self.degrade.values()), default=0)


def lower_faults(n_cores: int,
                 script: Any) -> FaultArrays | None:
    """Lower a fault script (:class:`repro_torch.faults.FaultScript`, or
    anything exposing its views: ``validate`` / ``fail_times`` / ``slow_events`` /
    ``degrade_events``) against a core count. ``None`` and already
    lowered :class:`FaultArrays` pass through, and an empty script
    lowers to ``None`` so the fault-free hot paths stay untouched."""
    if script is None or isinstance(script, FaultArrays):
        return script
    script.validate(n_cores)
    if not script.events:
        return None
    return FaultArrays(
        n_cores=n_cores,
        fail_t=_frozen(np.asarray(script.fail_times(n_cores), np.float64)),
        slow=tuple(tuple(s) for s in script.slow_events(n_cores)),
        degrade={k: tuple(v) for k, v in script.degrade_events().items()},
    )


# ---------------------------------------------------------------------------
# scenario lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioArrays:
    """One (graph, machine, schedule[, releases[, faults]]) scenario."""

    graph: GraphArrays
    machine: MachineArrays
    exec_core: np.ndarray           # (S, C) f64 — exec_type through core_types
    core_of: np.ndarray             # (S,)   int32 — assigned core per subtask
    start: np.ndarray               # (S,)   f64 — scheduled interval
    end: np.ndarray                 # (S,)   f64
    order_ptr: np.ndarray           # (C+1,) int32 — per-core order, CSR
    order_sid: np.ndarray           # (S,)   int32
    release: np.ndarray             # (S,)   f64 — floor on start (0 = free)
    release_order: np.ndarray       # int32 — sids with a floor, in the
    #   caller's dict-insertion order (release events enter the event
    #   heap in this order; ties in time break by it, like the seed)
    fault: FaultArrays | None = None        # degraded-run replay, or None

    @property
    def n_subtasks(self) -> int:
        return self.graph.n_subtasks

    @property
    def t_est(self) -> float:
        """The schedule's makespan — the paper's predicted T_est."""
        return float(self.end.max()) if len(self.end) else 0.0

    def duration(self) -> np.ndarray:
        """(S,) exec time on the assigned core (no jitter)."""
        if not len(self.core_of):
            return np.zeros(0)
        return self.exec_core[np.arange(len(self.core_of)), self.core_of]

    def prev_on_core(self) -> np.ndarray:
        """(S,) sid of the preceding subtask in the core's schedule
        order, or -1 — the implicit in-order execution edge."""
        prev = np.full(self.graph.n_subtasks, -1, np.int64)
        for c in range(self.machine.n_cores):
            lo, hi = self.order_ptr[c], self.order_ptr[c + 1]
            row = self.order_sid[lo:hi]
            prev[row[1:]] = row[:-1]
        return prev


def _release_arrays(s_count: int, releases: dict[int, float] | None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(release floors, release insertion order) — shared by every
    candidate of a population (one releases dict applies to all)."""
    release = np.zeros(s_count)
    release_order: list[int] = []
    if releases:
        for sid, t in releases.items():
            if not 0 <= sid < s_count:
                raise ValueError(
                    f"release for unknown subtask {sid} "
                    f"(graph has {s_count}); sid namespaces drifted?")
            release[sid] = float(t)
            release_order.append(sid)
    return _frozen(release), _frozen(np.asarray(release_order, np.int32))


def _placement_scenario(ga: GraphArrays, ma: MachineArrays,
                        exec_core: np.ndarray, schedule,
                        release: np.ndarray, release_order: np.ndarray,
                        fault: FaultArrays | None) -> ScenarioArrays:
    """The per-candidate tail of :func:`lower_scenario`: only the
    placement-dependent arrays (core assignment, intervals, per-core
    order) are built here — everything shared across a population
    (graph/machine arrays, exec gather, release floors) rides in."""
    s_count = ga.n_subtasks
    if len(schedule.placements) != s_count or \
            (s_count and set(schedule.placements) != set(range(s_count))):
        raise ValueError(
            f"schedule places {len(schedule.placements)} subtasks, graph has "
            f"{s_count}; lower the merged graph for multi-app timelines")
    core_of = np.zeros(s_count, np.int32)
    start = np.zeros(s_count)
    end = np.zeros(s_count)
    for sid, p in schedule.placements.items():
        core_of[sid] = p.core
        start[sid] = p.start
        end[sid] = p.end
    order_ptr = np.zeros(ma.n_cores + 1, np.int32)
    order_sid = np.zeros(s_count, np.int32)
    k = 0
    for c in range(ma.n_cores):
        row = schedule.order_on_core(c)
        order_ptr[c + 1] = order_ptr[c] + len(row)
        order_sid[k:k + len(row)] = row
        k += len(row)
    return ScenarioArrays(
        graph=ga, machine=ma, exec_core=exec_core,
        core_of=_frozen(core_of), start=_frozen(start), end=_frozen(end),
        order_ptr=_frozen(order_ptr), order_sid=_frozen(order_sid),
        release=release, release_order=release_order, fault=fault,
    )


def lower_scenario(graph: AppGraph, machine: MachineModel,
                   schedule: Any, *,
                   releases: dict[int, float] | None = None,
                   faults: Any = None) -> ScenarioArrays:
    """Lower one scenario. The schedule must place exactly this graph's
    subtasks (the merged-graph view of an online timeline qualifies).
    ``faults`` — a fault script (see :func:`lower_faults`) or a prelowered
    :class:`FaultArrays`, replayed during simulation."""
    ga = graph_arrays(graph)
    ma = machine_arrays(machine)
    release, release_order = _release_arrays(ga.n_subtasks, releases)
    return _placement_scenario(ga, ma, _exec_core(ga, ma), schedule,
                               release, release_order,
                               lower_faults(ma.n_cores, faults))


# ---------------------------------------------------------------------------
# batching — fixed (B, S, P) shape for the relaxation step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioBatch:
    """Scenarios padded to one shape. ``pad`` (== S) is the sentinel
    index: gather targets for missing predecessors / first-on-core
    subtasks point at an always-zero slot, and their lags are -inf so
    they never win the readiness max."""

    n_scenarios: int
    max_subtasks: int               # S (padded)
    max_preds: int                  # P (>= 1)
    n_sub: np.ndarray               # (B,)      int32 — valid subtask count
    duration: np.ndarray            # (B, S)    f64 — exec on assigned core
    release: np.ndarray             # (B, S)    f64
    prev: np.ndarray                # (B, S)    int64 — in-order edge, S = none
    pred: np.ndarray                # (B, S, P) int64 — dependency, S = pad
    pred_lat: np.ndarray            # (B, S, P) f64 — comm latency, -inf pad
    pred_volbw: np.ndarray          # (B, S, P) f64 — vol / bw, -inf pad
    wave: np.ndarray                # (B, S)    int32 — topological level
    t_est: np.ndarray               # (B,)      f64 — per-scenario makespan
    depth: int                      # relaxation steps to reach fixpoint
    # degraded-run replay (None on fault-free batches, keeping the hot
    # paths untouched): per-subtask views of each scenario's FaultArrays
    fail_t: np.ndarray | None = None        # (B, S) assigned core's fail, inf
    slow_t: np.ndarray | None = None        # (B, S, K) slow steps, inf pad
    slow_f: np.ndarray | None = None        # (B, S, K) factors, 1.0 pad
    deg_t: np.ndarray | None = None         # (B, S, P, K2) edge steps, inf pad
    deg_f: np.ndarray | None = None         # (B, S, P, K2) factors, 1.0 pad

    @property
    def has_faults(self) -> bool:
        return self.fail_t is not None

    @property
    def valid(self) -> np.ndarray:
        """(B, S) bool mask of real (non-padded) subtasks."""
        return np.arange(self.max_subtasks)[None, :] < self.n_sub[:, None]


def _graph_wave_views(ga: GraphArrays) -> tuple[list[list[int]], list[int]]:
    """(succ lists, pred counts) of the *graph's* dependency edges,
    cached on the frozen GraphArrays: they are shared by every scenario
    of the graph (a B-candidate mapping-search population pays them
    once, not B times); only the in-order core edge is per-scenario."""
    v = ga.__dict__.get("_wave_views")
    if v is None:
        n = ga.n_subtasks
        sp = ga.succ_ptr.tolist()
        ss = ga.succ_sid.tolist()
        pp = ga.pred_ptr.tolist()
        v = ([ss[sp[s]:sp[s + 1]] for s in range(n)],
             [pp[s + 1] - pp[s] for s in range(n)])
        object.__setattr__(ga, "_wave_views", v)
    return v


def _scenario_waves(sa: ScenarioArrays, prev: np.ndarray) -> list[int]:
    """Per-subtask topological level over deps ∪ in-order edges (the
    longest path from a source, in subtasks, minus one). Wave ``w``
    subtasks depend only on waves ``< w``, so one wave-ordered pass —
    or ``max(wave) + 1`` synchronous sweeps — reaches the fixpoint.
    Pure-Python Kahn walk: list indexing here is hot at batch-build
    time and ~10x cheaper than NumPy scalar ops. The graph's adjacency
    rides in from the GraphArrays cache; the scenario's in-order edge
    is the ``next_on_core`` inverse of ``prev``."""
    n = sa.graph.n_subtasks
    if n == 0:
        return []
    succs, pred_count = _graph_wave_views(sa.graph)
    prev_l = prev.tolist()
    nxt = [-1] * n
    for s, p in enumerate(prev_l):
        if p >= 0:
            nxt[p] = s
    indeg = [c + (prev_l[s] >= 0) for s, c in enumerate(pred_count)]
    wave = [0] * n
    stack = [s for s in range(n) if indeg[s] == 0]
    seen = 0
    while stack:
        s = stack.pop()
        seen += 1
        w1 = wave[s] + 1
        for t in succs[s]:
            if wave[t] < w1:
                wave[t] = w1
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
        t = nxt[s]
        if t >= 0:
            if wave[t] < w1:
                wave[t] = w1
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
    assert seen == n, "scenario dependency graph has a cycle"
    return wave


def batch_scenarios(scenarios: list[ScenarioArrays]) -> ScenarioBatch:
    """Pad scenarios (possibly of different graphs AND machines) to one
    fixed-shape batch for :func:`repro_torch.core.sim_engine.relax_wave_np`
    / the ``sim_relax_pop`` kernel."""
    if not scenarios:
        raise ValueError("batch_scenarios needs at least one scenario")
    b = len(scenarios)
    s_max = max(sa.graph.n_subtasks for sa in scenarios)
    p_max = max(1, max(int((sa.graph.pred_ptr[1:] - sa.graph.pred_ptr[:-1])
                           .max(initial=0)) for sa in scenarios))
    pad = s_max
    n_sub = np.zeros(b, np.int32)
    duration = np.zeros((b, s_max))
    release = np.zeros((b, s_max))
    prev = np.full((b, s_max), pad, np.int64)
    pred = np.full((b, s_max, p_max), pad, np.int64)
    pred_lat = np.full((b, s_max, p_max), -np.inf)
    pred_volbw = np.full((b, s_max, p_max), -np.inf)
    wave = np.zeros((b, s_max), np.int32)
    t_est = np.zeros(b)
    depth = 0
    faulty = [sa.fault for sa in scenarios]
    has_faults = any(f is not None for f in faulty)
    k_slow = max((f.max_slow_events for f in faulty if f is not None),
                 default=0)
    k_deg = max((f.max_degrade_events for f in faulty if f is not None),
                default=0)
    if has_faults:
        fail_t = np.full((b, s_max), np.inf)
        slow_t = np.full((b, s_max, k_slow), np.inf)
        slow_f = np.ones((b, s_max, k_slow))
        deg_t = np.full((b, s_max, p_max, k_deg), np.inf)
        deg_f = np.ones((b, s_max, p_max, k_deg))
    for i, sa in enumerate(scenarios):
        n = sa.graph.n_subtasks
        n_sub[i] = n
        if n == 0:
            continue
        duration[i, :n] = sa.duration()
        release[i, :n] = sa.release
        prev_i = sa.prev_on_core()
        has_prev = prev_i >= 0
        prev[i, :n][has_prev] = prev_i[has_prev]
        ptr, psid, pvol = sa.graph.pred_ptr, sa.graph.pred_sid, \
            sa.graph.pred_vol
        counts = (ptr[1:] - ptr[:-1]).astype(np.int64)
        dst = np.repeat(np.arange(n), counts)       # edge -> consumer sid
        col = np.arange(len(psid)) - np.repeat(ptr[:-1].astype(np.int64),
                                               counts)
        cp = sa.core_of[psid]
        cs = sa.core_of[dst]
        # same-core / volume-free edges arrive instantly (no latency),
        # matching the event simulator; same-core bw is inf so vol/bw
        # is an exact 0.0 there already
        lag_lat = np.where(pvol <= 0.0, 0.0, sa.machine.lat[cp, cs])
        lag_volbw = np.where(pvol <= 0.0, 0.0, pvol / sa.machine.bw[cp, cs])
        pred[i, dst, col] = psid
        pred_lat[i, dst, col] = lag_lat
        pred_volbw[i, dst, col] = lag_volbw
        if sa.fault is not None:
            fl = sa.fault
            fail_t[i, :n] = fl.fail_t[sa.core_of]
            for sid in range(n):
                for k, (t, f) in enumerate(fl.slow[sa.core_of[sid]]):
                    slow_t[i, sid, k] = t
                    slow_f[i, sid, k] = f
            if fl.degrade:
                # degrade applies only to edges that pay comm, like the
                # event loop's start_transfer (a != b and volume > 0)
                for e in range(len(psid)):
                    a, c2 = int(cp[e]), int(cs[e])
                    if a == c2 or pvol[e] <= 0.0:
                        continue
                    steps = fl.degrade.get((min(a, c2), max(a, c2)))
                    for k, (t, f) in enumerate(steps or ()):
                        deg_t[i, dst[e], col[e], k] = t
                        deg_f[i, dst[e], col[e], k] = f
        waves_i = _scenario_waves(sa, prev_i)
        wave[i, :n] = waves_i
        t_est[i] = sa.t_est
        depth = max(depth, max(waves_i) + 1 if waves_i else 0)
    fault_fields = {} if not has_faults else {
        "fail_t": _frozen(fail_t), "slow_t": _frozen(slow_t),
        "slow_f": _frozen(slow_f), "deg_t": _frozen(deg_t),
        "deg_f": _frozen(deg_f)}
    return ScenarioBatch(
        n_scenarios=b, max_subtasks=s_max, max_preds=p_max,
        n_sub=_frozen(n_sub), duration=_frozen(duration),
        release=_frozen(release), prev=_frozen(prev), pred=_frozen(pred),
        pred_lat=_frozen(pred_lat), pred_volbw=_frozen(pred_volbw),
        wave=_frozen(wave), t_est=_frozen(t_est), depth=depth,
        **fault_fields)


def lower_population(graph: AppGraph, machine: MachineModel,
                     schedules: list[Any], *,
                     releases: dict[int, float] | None = None
                     ) -> ScenarioBatch:
    """Lower ``B`` candidate schedules of ONE (graph, machine) pair into
    a single batch — the mapping-search fitness shape (``repro_torch.search``
    scores whole populations through one ``simulate_batch`` call).

    Same-graph batches need no per-scenario shape search: ``S`` and
    ``P`` are fixed by the shared graph, the graph/machine arrays are
    gathered once from the caches, and only the placement-dependent
    arrays (core assignment, intervals, core order) differ per
    candidate. ``releases`` (one shared map, e.g. online admission
    floors) applies to every candidate."""
    ga = graph_arrays(graph)
    ma = machine_arrays(machine)
    exec_core = _exec_core(ga, ma)
    release, release_order = _release_arrays(ga.n_subtasks, releases)
    scenarios = [_placement_scenario(ga, ma, exec_core, s,
                                     release, release_order, None)
                 for s in schedules]
    return batch_scenarios(scenarios)


def repeat_batch(batch: ScenarioBatch, k: int) -> ScenarioBatch:
    """Tile a batch ``k`` times along the scenario axis (the jitter- or
    seed-sweep shape: same scenarios, different draws) without paying
    the batch construction again."""
    if k <= 1:
        return batch
    fields = ["n_sub", "duration", "release", "prev", "pred",
              "pred_lat", "pred_volbw", "wave", "t_est"]
    if batch.has_faults:
        fields += ["fail_t", "slow_t", "slow_f", "deg_t", "deg_f"]
    rep = {f: _frozen(np.tile(getattr(batch, f),
                              (k,) + (1,) * (getattr(batch, f).ndim - 1)))
           for f in fields}
    return ScenarioBatch(
        n_scenarios=batch.n_scenarios * k,
        max_subtasks=batch.max_subtasks, max_preds=batch.max_preds,
        depth=batch.depth, **rep)


# ---------------------------------------------------------------------------
# population lowering — device-resident mapping search (repro_torch.search.device)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PopulationArrays:
    """Pre-lowered (graph, machine) constants for *device-side*
    population fitness: everything a genome needs to decode into finish
    times is resolved to fixed-shape arrays in one fixed topological
    order, so a whole GA generation is pure gathers + one scan — no
    per-candidate re-lowering, ever. All per-subtask arrays live in
    **topological-position coordinates** (``topo_sid`` maps back to
    sids); predecessor slots are padded to ``max_preds`` with the
    sentinel position ``S`` (an always-zero end slot).

    Built once per (graph, machine) pair and cached on the graph — the
    population axis exists only on device, this object is candidate-free.
    """

    n_tasks: int
    n_subtasks: int                 # S
    n_cores: int                    # C
    max_preds: int                  # P (>= 1)
    topo_sid: np.ndarray            # (S,)   int32 — topo position -> sid
    gene: np.ndarray                # (S,)   int32 — gene slot of the task
    exec_core: np.ndarray           # (S, C) f64 — topo-permuted exec times
    pred_pos: np.ndarray            # (S, P) int32 — pred topo position, S pad
    pred_gene: np.ndarray           # (S, P) int32 — pred's gene slot, 0 pad
    pred_vol: np.ndarray            # (S, P) f64 — edge volume, 0 pad
    lat: np.ndarray                 # (C, C) f64
    bw: np.ndarray                  # (C, C) f64


def population_arrays(graph: AppGraph, machine: MachineModel
                      ) -> PopulationArrays:
    """Lower one (graph, machine) pair for device-resident search.

    The topological order is the same deterministic sid-ordered Kahn
    walk the host decoder uses (``search.encoding.topo_order``), so an
    append-only device decode and the host ``decode(gap_fill=False)``
    place subtasks in the same sequence."""
    import heapq

    ga = graph_arrays(graph)
    ma = machine_arrays(machine)
    cached = getattr(graph, "_population_arrays", None)
    fp = (len(graph.subtasks), len(graph.edges))
    if cached is not None and cached[0] == fp and cached[1] is ma:
        return cached[2]
    s = ga.n_subtasks
    indeg = (ga.pred_ptr[1:] - ga.pred_ptr[:-1]).tolist()
    succ_ptr, succ_sid = ga.succ_ptr.tolist(), ga.succ_sid.tolist()
    heap = [i for i in range(s) if indeg[i] == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        sid = heapq.heappop(heap)
        order.append(sid)
        for j in range(succ_ptr[sid], succ_ptr[sid + 1]):
            t = succ_sid[j]
            indeg[t] -= 1
            if indeg[t] == 0:
                heapq.heappush(heap, t)
    assert len(order) == s, "graph has a cycle"
    topo_sid = np.asarray(order, np.int32)
    pos_of = np.zeros(s, np.int64)
    pos_of[topo_sid] = np.arange(s)
    gene_of_tid = {tid: k for k, tid in enumerate(graph.tasks)}
    gene_sid = np.asarray([gene_of_tid[st.task_id] for st in graph.subtasks],
                          np.int32) if s else np.zeros(0, np.int32)
    p_max = max(1, int((ga.pred_ptr[1:] - ga.pred_ptr[:-1]).max(initial=0)))
    pred_pos = np.full((s, p_max), s, np.int32)
    pred_gene = np.zeros((s, p_max), np.int32)
    pred_vol = np.zeros((s, p_max))
    ptr = ga.pred_ptr
    for p in range(s):
        sid = int(topo_sid[p])
        lo, hi = int(ptr[sid]), int(ptr[sid + 1])
        k = hi - lo
        pred_pos[p, :k] = pos_of[ga.pred_sid[lo:hi]]
        pred_gene[p, :k] = gene_sid[ga.pred_sid[lo:hi]]
        pred_vol[p, :k] = ga.pred_vol[lo:hi]
    pa = PopulationArrays(
        n_tasks=ga.n_tasks, n_subtasks=s, n_cores=ma.n_cores,
        max_preds=p_max,
        topo_sid=_frozen(topo_sid),
        gene=_frozen(gene_sid[topo_sid] if s else gene_sid),
        exec_core=_frozen(_exec_core(ga, ma)[topo_sid]),
        pred_pos=_frozen(pred_pos), pred_gene=_frozen(pred_gene),
        pred_vol=_frozen(pred_vol), lat=ma.lat, bw=ma.bw,
    )
    graph._population_arrays = (fp, ma, pa)
    return pa


def dense_lags(batch: ScenarioBatch) -> tuple[np.ndarray, np.ndarray]:
    """(B, S, S) dense latency / vol-over-bw lag tensors for the
    ``sim_step`` kernel (``kernels/csrc/sim_step.cu``) (``-inf`` where no edge): entry ``[b, t, q]`` is
    the lag of edge ``q -> t``. In-order core edges appear as 0-lag
    entries; parallel edges between the same pair keep the largest
    total lag (the only one that can win the readiness max). Fully
    vectorized scatter (the kernel path must not pay a Python triple
    loop per call) and cached on the batch."""
    cached = batch.__dict__.get("_dense_lags")
    if cached is not None:
        return cached
    b, s = batch.n_scenarios, batch.max_subtasks
    # all edges incl. the zero-lag in-order one, sentinel column q = s
    src = np.concatenate([batch.pred, batch.prev[:, :, None]], axis=2)
    e_lat = np.concatenate(
        [batch.pred_lat,
         np.where(batch.prev[:, :, None] < s, 0.0, -np.inf)], axis=2)
    e_volbw = np.concatenate(
        [batch.pred_volbw,
         np.where(batch.prev[:, :, None] < s, 0.0, -np.inf)], axis=2)
    # flat (b, t, q) slot per edge, width s+1 so the sentinel lands in a
    # dropped column; keep only the max-total-lag edge per slot
    slot = ((np.arange(b)[:, None, None] * s
             + np.arange(s)[None, :, None]) * (s + 1) + src).reshape(-1)
    total = (e_lat + e_volbw).reshape(-1)
    real = np.isfinite(total)
    slot, total = slot[real], total[real]
    best = np.full(b * s * (s + 1), -np.inf)
    np.maximum.at(best, slot, total)
    win = total == best[slot]
    lat_flat = np.full(b * s * (s + 1), -np.inf)
    volbw_flat = np.full(b * s * (s + 1), -np.inf)
    lat_flat[slot[win]] = e_lat.reshape(-1)[real][win]
    volbw_flat[slot[win]] = e_volbw.reshape(-1)[real][win]
    lat = lat_flat.reshape(b, s, s + 1)[:, :, :s]
    volbw = volbw_flat.reshape(b, s, s + 1)[:, :, :s]
    object.__setattr__(batch, "_dense_lags", (lat, volbw))
    return lat, volbw
