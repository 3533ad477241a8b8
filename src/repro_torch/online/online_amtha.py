"""Incremental AMTHA: admit one application against residual capacity.

The offline algorithm (Fig. 3 of the paper) is unchanged — rank
selection, LU/LNU-aware processor choice, cascade gap placement. What
changes is the machine it sees: instead of an empty timeline it
warm-starts on the cluster's occupied one, so the §3.4 gap search
("a free interval between two subtasks already placed in p, or an
interval after them") now packs the new app into holes left by earlier
apps, and no subtask may start before the app's arrival instant.

Two execution paths share the admission semantics:

* **engine** (default) — the array-backed :class:`ArrayAMTHA` runs
  directly on the live :class:`~repro_torch.core.timeline.Timeline` inside a
  transaction: ``predict()`` is ``begin → run → rollback`` (O(ops) to
  rewind) and ``admit()`` is ``begin → run → commit``. No timeline copy
  is ever taken, which is what makes what-if cost independent of how
  much history the cluster has accumulated.
* **seed** (``use_engine=False``) — the original copy-the-timeline /
  merge-on-success path, kept as the equivalence oracle and the
  baseline the what-if benchmark measures against.

Both paths produce placement-identical timelines. On an idle cluster at
t=0 this degenerates to the paper's offline run exactly — a property
the tests pin down (warm == cold).
"""

from __future__ import annotations

from ..core.amtha import AMTHA
from ..core.engine import ArrayAMTHA
from ..core.machine import MachineModel
from .arrivals import AppArrival
from .state import AdmittedApp, ClusterState


class OnlineAMTHA:
    """Admission engine over a :class:`ClusterState`."""

    def __init__(self, machine: MachineModel, use_engine: bool = True,
                 ga_refine: bool = False, ga_seed: int = 0,
                 ga_params=None, verify: bool = False):
        self.machine = machine
        self.state = ClusterState(machine)
        self.use_engine = use_engine
        # optional post-admission GA pass (see refine_ga); off by default
        self.ga_refine = ga_refine
        self.ga_seed = ga_seed
        self.ga_params = ga_params
        # proof-check the whole cluster after every committed admission
        # (repro_torch.analysis.verify_cluster); off by default — it is
        # O(all live work), the per-admission cost the transaction design
        # exists to avoid, so it is a debug/CI switch, not a default
        self.verify = verify

    # ------------------------------------------------------------------
    def predict(self, arrival: AppArrival, at: float | None = None) -> float:
        """Predicted finish if ``arrival`` were admitted now — evaluated
        inside a transaction on the live timeline (engine path) or on a
        throwaway copy (seed path), nothing committed. This is the cheap
        what-if the policies use to order/filter a queue."""
        t = arrival.t_arrival if at is None else at
        off = self.state.peek_offset()      # peek, do not reserve
        # same floor admit() would use: never before the cluster clock
        release = max(self.state.now, t, arrival.t_arrival)
        n = arrival.graph.n_subtasks
        if self.use_engine:
            tl = self.state.schedule
            # constructor validates before the transaction opens
            eng = ArrayAMTHA(arrival.graph, self.machine, warm_start=tl,
                             release_time=release, sid_offset=off)
            # commit=False: a what-if always rewinds, success included
            with tl.transaction(commit=False):
                eng.run()
                return max(tl.placements[off + s].end for s in range(n))
        trial = self.state.schedule.copy()
        AMTHA(arrival.graph, self.machine, warm_start=trial,
              release_time=release, sid_offset=off).run()
        return max(trial.placements[off + s].end for s in range(n))

    def admit(self, arrival: AppArrival, at: float | None = None) -> AdmittedApp:
        """Schedule ``arrival`` into the live timeline and commit it.

        ``at`` — the admission instant (defaults to the arrival time;
        batched policies admit later than the app arrived). The release
        floor is ``max(at, t_arrival)``: a queued app still cannot start
        before it was admitted. Transactional either way: a failed
        admission (type mismatch, mid-run assert) leaves the cluster
        state untouched.
        """
        t = arrival.t_arrival if at is None else at
        self.state.advance_to(t)
        off = self.state.peek_offset()
        release = max(t, arrival.t_arrival)
        if self.use_engine:
            tl = self.state.schedule
            eng = ArrayAMTHA(arrival.graph, self.machine, warm_start=tl,
                             release_time=release, sid_offset=off)
            with tl.transaction():
                eng.run()
        else:
            trial = self.state.schedule.copy()
            AMTHA(arrival.graph, self.machine, warm_start=trial,
                  release_time=release, sid_offset=off).run()
            self.state.commit_trial(trial)
        reserved = self.state.allot_offset(arrival.graph)
        assert reserved == off
        admitted = self.state.commit(arrival, off, t_admit=t)
        if self.verify:
            from ..analysis.verify import verify_cluster
            verify_cluster(self.state)
        if self.ga_refine and self._can_refine():
            self.refine_ga(seed=self.ga_seed, params=self.ga_params)
        return admitted

    def _can_refine(self) -> bool:
        """Refinement pins already-started work (``start < now`` —
        including history a recovery just rolled back around) and
        re-places the rest, so it applies whenever at least one
        placement is still in the future."""
        cur = self.state.schedule
        return any(p.start >= self.state.now - 1e-9
                   for p in cur.placements.values())

    # ------------------------------------------------------------------
    def refine_ga(self, *, seed: int = 0, params=None) -> tuple[float, float]:
        """Re-map the admitted workload with the GA mapping search
        (``repro_torch.search``), the current timeline riding as the elite
        individual, and swap the cluster timeline for the evolved one
        when it is strictly better. Returns ``(old, new)`` makespans.

        Work that has already started (``start < now``) is *frozen*:
        its placements are pinned verbatim into every candidate and
        only the future is searched — which is what lets fault recovery
        reuse this mid-flight, right after rolling back the unstarted
        intervals of a dead core. With nothing started this degenerates
        to the original whole-timeline planning pass. Release floors
        are preserved: every free subtask keeps its app's admission
        floor ``max(t_admit, t_arrival)`` (raised to ``now`` when
        history is frozen, so nothing re-plans into the past)."""
        st = self.state
        cur = st.schedule
        if not st.apps or not cur.placements:
            return 0.0, 0.0
        frozen = {sid: p for sid, p in cur.placements.items()
                  if p.start < st.now - 1e-9}
        if len(frozen) == len(cur.placements):
            old = cur.makespan()
            return old, old                 # nothing left to re-place
        from ..search.encoding import decode, encode
        from ..search.ga import GAParams, ga_search
        merged = st.merged_graph()
        rel: dict[int, float] = {}
        for a in st.apps:
            floor = max(a.t_admit, a.arrival.t_arrival)
            if frozen:
                floor = max(floor, st.now)
            for s in a.global_sids():
                if s not in frozen:     # history carries its own times
                    rel[s] = floor
        par = params or GAParams(pop_size=16, generations=10,
                                 refine_rounds=2, refine_moves=32)
        elite = encode(merged, cur, strict=False)
        vec, _ = ga_search(merged, self.machine, seed=seed, params=par,
                           elites=[elite], releases=rel,
                           frozen=frozen or None)
        cand = decode(merged, self.machine, vec, releases=rel,
                      frozen=frozen or None)
        old = cur.makespan()
        if cand.makespan() >= old - 1e-12:
            return old, old
        st.schedule = cand
        if frozen:
            st.task_coherent = False        # pinned history may split tasks
        for a in st.apps:
            a.t_est_finish = max(cand.placements[s].end
                                 for s in a.global_sids())
        return old, cand.makespan()


def replay_fifo(machine: MachineModel, workload: list[AppArrival],
                validate_each: bool = False,
                use_engine: bool = True) -> ClusterState:
    """Convenience: admit a whole workload first-come-first-served."""
    eng = OnlineAMTHA(machine, use_engine=use_engine)
    for arr in sorted(workload, key=lambda a: a.t_arrival):
        eng.admit(arr)
        if validate_each:
            eng.state.validate()
    return eng.state
