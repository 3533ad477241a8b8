"""Mutable cluster state: the shared timeline many applications live in.

``ClusterState`` wraps one global :class:`~repro_torch.core.timeline.Timeline`
whose subtask ids are namespaced per admitted app (each app gets a
``sid_offset``), plus per-core *frontiers* — the earliest instant each
core can take new work, which is ``max(now, last reserved end)``. A new
app is scheduled against this residual capacity (the gap lists of the
occupied timeline) instead of an empty machine; that is the whole
difference between the paper's offline AMTHA and the online subsystem.

The state can always reconstitute a single offline-equivalent picture of
itself — ``merged_graph()`` unions all admitted apps (with the same sid
offsets the schedule uses) so ``core.validate`` and ``core.simulate``
apply unchanged to the multiprogrammed timeline.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.machine import MachineModel
from ..core.mpaha import AppGraph, merge_graphs
from ..core.schedule import validate
from ..core.timeline import Timeline
from .arrivals import AppArrival


@dataclass
class AdmittedApp:
    """Bookkeeping for one application committed to the timeline."""

    arrival: AppArrival
    sid_offset: int
    t_admit: float                  # when the scheduler placed it
    t_est_finish: float             # predicted finish (schedule end)

    @property
    def app_id(self) -> int:
        return self.arrival.app_id

    @property
    def est_response(self) -> float:
        return self.t_est_finish - self.arrival.t_arrival

    @property
    def est_meets_deadline(self) -> bool:
        return self.t_est_finish <= self.arrival.deadline + 1e-9

    def global_sids(self) -> range:
        return range(self.sid_offset,
                     self.sid_offset + self.arrival.graph.n_subtasks)


@dataclass(frozen=True)
class ShedApp:
    """Summary of an app dropped by recovery (placements removed)."""

    app_id: int
    criticality: int
    t_arrival: float
    deadline: float
    t_shed: float


class ClusterState:
    """The residual-capacity view AMTHA warm-starts against."""

    def __init__(self, machine: MachineModel):
        self.machine = machine
        # array-backed: O(log slots) gap search and journaled what-ifs
        self.schedule = Timeline(machine.n_cores)
        self.apps: list[AdmittedApp] = []
        self.now = 0.0
        self._next_sid = 0
        # recovery may split a task across cores (partial completion);
        # validate() relaxes coherence once that has happened
        self.task_coherent = True
        # ---- bounded-state bookkeeping (compact / shed) ----
        self.retired_busy = [0.0] * machine.n_cores   # per-core, pre-compaction
        self.n_retired = 0
        self.retired_by_tier: dict[int, int] = {}
        self.retired_est_miss_by_tier: dict[int, int] = {}
        self.shed: list[ShedApp] = []

    # ---- clock ---------------------------------------------------------
    def advance_to(self, t: float) -> None:
        if t < self.now - 1e-9:
            raise ValueError(f"time moves forward: {t} < {self.now}")
        self.now = max(self.now, t)

    # ---- residual capacity --------------------------------------------
    def frontier(self, core: int) -> float:
        """Earliest instant ``core`` can take *appended* work."""
        return max(self.now, self.schedule.core_available(core))

    def frontiers(self) -> list[float]:
        return [self.frontier(c) for c in range(self.machine.n_cores)]

    def gaps(self, core: int, horizon: float = float("inf")) -> list[tuple[float, float]]:
        """Free intervals on ``core`` from ``now`` on (incl. the open end)."""
        return self.schedule.gaps(core, horizon=horizon, after=self.now)

    def utilization(self, horizon: float | None = None) -> float:
        """Busy fraction of the machine over [0, horizon]. Retired
        (compacted-away) intervals still count: they all ended at or
        before the compaction watermark, so their busy time lies fully
        inside any ``horizon >= watermark`` a caller would use."""
        h = horizon if horizon is not None else self.schedule.makespan()
        if h <= 0.0:
            return 0.0
        busy = sum(self.retired_busy)
        busy += sum(min(e, h) - min(s, h)
                    for slots in self.schedule.core_slots
                    for s, e, _ in slots)
        return busy / (h * self.machine.n_cores)

    # ---- admission bookkeeping ----------------------------------------
    def peek_offset(self) -> int:
        """The sid offset the next admitted app will get (not reserved)."""
        return self._next_sid

    def allot_offset(self, graph: AppGraph) -> int:
        """Reserve the sid namespace for the next admitted app."""
        off = self._next_sid
        self._next_sid += graph.n_subtasks
        return off

    def commit_trial(self, trial) -> None:
        """Adopt a tentatively scheduled timeline's new placements in
        bulk (one append + sort per touched core via ``extend_sorted``,
        not per-placement sorted inserts)."""
        self.schedule.merge_from(trial)

    def commit(self, arrival: AppArrival, sid_offset: int,
               t_admit: float) -> AdmittedApp:
        ends = [self.schedule.placements[s].end
                for s in range(sid_offset, sid_offset + arrival.graph.n_subtasks)]
        app = AdmittedApp(arrival=arrival, sid_offset=sid_offset,
                          t_admit=t_admit, t_est_finish=max(ends))
        self.apps.append(app)
        return app

    @property
    def n_admitted(self) -> int:
        return len(self.apps)

    # ---- bounded state: compaction + shedding -------------------------
    def _rebase(self) -> None:
        """Re-pack the sid namespace to admission order after apps left
        the live set (retired or shed), so ``merged_graph`` and the
        timeline agree again and ``_next_sid`` stays O(live work)."""
        remap: dict[int, int] = {}
        off = 0
        for a in self.apps:
            n = a.arrival.graph.n_subtasks
            if a.sid_offset != off:
                for s in range(n):
                    remap[a.sid_offset + s] = off + s
            a.sid_offset = off
            off += n
        if remap:
            self.schedule.compact((), remap)
        self._next_sid = off

    def compact(self, upto: float | None = None) -> int:
        """Retire every app whose *entire* timeline footprint ends at or
        before ``upto`` (default: ``now``; never past ``now``) — whole
        apps only, so the merged-graph/namespace invariant survives.
        Their intervals leave the Timeline (memory and ``earliest_slot``
        cost drop to O(live work)); their busy time and outcome tier
        move into aggregate counters that ``utilization()`` and the
        metrics still see. Returns the number of apps retired."""
        tl = self.schedule
        assert not tl.in_transaction, "compact inside a transaction"
        watermark = self.now if upto is None else min(upto, self.now)
        keep: list[AdmittedApp] = []
        retire_sids: set[int] = set()
        for a in self.apps:
            sids = list(a.global_sids())
            if all(tl.placements[s].end <= watermark + 1e-9 for s in sids):
                retire_sids.update(sids)
                tier = a.arrival.criticality
                self.n_retired += 1
                self.retired_by_tier[tier] = \
                    self.retired_by_tier.get(tier, 0) + 1
                if not a.est_meets_deadline:
                    self.retired_est_miss_by_tier[tier] = \
                        self.retired_est_miss_by_tier.get(tier, 0) + 1
            else:
                keep.append(a)
        n_retired = len(self.apps) - len(keep)
        if n_retired == 0:
            return 0
        for p in tl.compact(retire_sids).values():
            self.retired_busy[p.core] += p.end - p.start
        self.apps = keep
        self._rebase()
        return n_retired

    def drop_apps(self, app_ids, t: float | None = None) -> None:
        """Forget shed apps — their placements must already be off the
        timeline (recovery removed them inside its transaction) — and
        re-pack the sid namespace. Keeps a :class:`ShedApp` record per
        drop so metrics can score sheds as misses."""
        app_ids = set(app_ids)
        t = self.now if t is None else t
        keep: list[AdmittedApp] = []
        for a in self.apps:
            if a.app_id in app_ids:
                for s in a.global_sids():
                    assert s not in self.schedule.placements, \
                        f"shed app {a.app_id} still has sid {s} placed"
                self.shed.append(ShedApp(
                    app_id=a.app_id, criticality=a.arrival.criticality,
                    t_arrival=a.arrival.t_arrival,
                    deadline=a.arrival.deadline, t_shed=t))
            else:
                keep.append(a)
        self.apps = keep
        self._rebase()

    # ---- whole-cluster views ------------------------------------------
    def merged_graph(self) -> AppGraph:
        """All admitted apps as one MPAHA graph, sid-aligned with the
        global schedule."""
        merged, offsets = merge_graphs([a.arrival.graph for a in self.apps])
        assert offsets == [a.sid_offset for a in self.apps], \
            "admission order and sid namespace drifted apart"
        return merged

    def releases(self) -> dict[int, float]:
        """Per-subtask release instants for the simulator's injection
        hook: an app's root subtasks may not start before it arrived."""
        rel: dict[int, float] = {}
        for a in self.apps:
            g = a.arrival.graph
            g.finalize()
            for s in range(g.n_subtasks):
                if not g.preds[s]:
                    rel[a.sid_offset + s] = a.arrival.t_arrival
        return rel

    def validate(self) -> None:
        """Every offline invariant, on the multiprogrammed timeline —
        plus online causality: nothing starts before its app arrived.
        Correct after compaction (the merged graph and the timeline
        shrink together) and after recovery (``task_coherent`` goes
        False once a partially-executed task was re-mapped split)."""
        if not self.apps:
            return
        validate(self.schedule, self.merged_graph(), self.machine,
                 require_task_coherence=self.task_coherent)
        for a in self.apps:
            for s in a.global_sids():
                if self.schedule.placements[s].start < a.arrival.t_arrival - 1e-9:
                    raise AssertionError(
                        f"app {a.app_id}: subtask {s} starts before arrival")
