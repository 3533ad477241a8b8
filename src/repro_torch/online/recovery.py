"""Fault detection and warm-started recovery on the live timeline.

The injection side (``repro_torch.faults``) degrades a run deterministically;
this module is the scheduler's answer. Three stages, all on the same
transactional Timeline the admissions use:

* **detect** — either replay the ground-truth script prefix
  (:func:`detect_script`, what a perfect health monitor would report)
  or compare observed subtask completions against the planned timeline
  (:func:`detect_progress` — a core whose planned-done work never
  finished is presumed dead, one whose completions lag plan by more
  than ``straggle_factor`` is a straggler);
* **recover** — one ``begin → rollback intervals → re-place → validate
  → commit`` transaction: every interval that a dead core stranded (or
  a straggler would delay, plus all their transitive dependents not yet
  started) is removed via the Timeline journal and re-placed onto
  surviving cores by a greedy earliest-finish walk in topological
  order, floors never before the detection instant. If the re-mapped
  plan fails validation or leaves the *highest* criticality tier
  missing deadlines, the transaction rolls back and retries with an
  exponentially backed-off release delay; when retries are exhausted
  the lowest-criticality still-unstarted apps are shed (their intervals
  leave the plan, recorded on ``ClusterState.shed``) and the re-map
  runs again against the freed capacity — arXiv:1403.8020's
  degrade-low-priority-first under pressure;
* **refine** — optionally polish the recovered plan with the frozen
  (mid-flight) GA pass of :meth:`OnlineAMTHA.refine_ga`.

Recovered timelines are generally not task-coherent (a task whose
prefix already executed on the dead core re-maps its suffix elsewhere),
so ``ClusterState.task_coherent`` drops to False and every later
``validate()`` checks the remaining invariants.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from ..core.schedule import ScheduleError
from .online_amtha import OnlineAMTHA
from .state import ClusterState


@dataclass(frozen=True)
class RecoveryParams:
    """Retry budget and shedding thresholds."""

    max_retries: int = 3            # re-map attempts before shedding a tier
    retry_delay: float = 1.0        # first retry's extra release delay
    backoff: float = 2.0            # delay multiplier per retry
    straggle_factor: float = 1.5    # slow factor that evicts future work
    shed: bool = True               # False: never drop apps (baseline)
    ga_refine: bool = False         # polish with the frozen GA pass
    ga_seed: int = 0
    ga_params: object = None
    # prove the committed plan with repro_torch.analysis.verify_cluster
    # after the pass completes (post-shed/-refine, so namespaces are settled)
    verify: bool = False


@dataclass
class RecoveryReport:
    """What one recovery pass did (benchmark + test introspection)."""

    t_detect: float
    dead_cores: tuple[int, ...]
    slow_cores: tuple[int, ...]
    n_lost: int                     # killed in flight, re-run elsewhere
    n_rolled_back: int              # intervals removed from the plan
    n_replaced: int                 # intervals re-placed
    shed_app_ids: tuple[int, ...] = ()
    retries: int = 0
    old_makespan: float = 0.0
    new_makespan: float = 0.0
    notes: list[str] = field(default_factory=list)


@dataclass(frozen=True)
class Detection:
    """Health verdict at one instant."""

    at: float
    dead: frozenset[int]
    slow: dict[int, float]          # core -> cumulative slow factor
    fail_t: dict[int, float]        # dead core -> fail instant

    @property
    def any(self) -> bool:
        return bool(self.dead or self.slow)


def detect_script(state: ClusterState, script, at: float,
                  straggle_factor: float = 1.5) -> Detection:
    """Ground-truth detection: what the script says has happened by
    ``at`` (the perfect-monitor upper bound real detectors approach)."""
    n = state.machine.n_cores
    known = script.until(at)
    dead = frozenset(known.dead_cores(at))
    slow = {}
    for c in range(n):
        if c in dead:
            continue
        f = known.slow_factor(c, at)
        if f >= straggle_factor:
            slow[c] = f
    fail_t = {c: t for c, t in enumerate(script.fail_times(n))
              if c in dead}
    return Detection(at=at, dead=dead, slow=slow, fail_t=fail_t)


def detect_progress(state: ClusterState, subtask_end, at: float,
                    straggle_factor: float = 1.5,
                    grace: float = 1e-9) -> Detection:
    """Frontier-vs-expected detection from observed completions.

    ``subtask_end`` maps sid -> observed finish (``inf`` = not yet /
    never; e.g. ``SimResult.subtask_end`` of a faulty replay). A core
    with work planned to be done by ``at`` that never finished is
    presumed **dead** (its fail instant estimated as the earliest such
    planned start); one whose completions took more than
    ``straggle_factor`` x the planned service time is a **straggler**."""
    tl = state.schedule
    dead: set[int] = set()
    fail_t: dict[int, float] = {}
    slow: dict[int, float] = {}
    inf = float("inf")
    for core in range(state.machine.n_cores):
        worst = 1.0
        for sid in tl.order_on_core(core):
            p = tl.placements[sid]
            if p.end > at + grace:
                break               # plan says still running/future
            obs = subtask_end.get(sid, inf)
            if obs == inf:
                dead.add(core)
                fail_t[core] = min(fail_t.get(core, inf), p.start)
                break
            planned = p.end - p.start
            if planned > grace and obs > p.start + grace:
                worst = max(worst, (obs - p.start) / planned)
        if core not in dead and worst >= straggle_factor:
            slow[core] = worst
    return Detection(at=at, dead=frozenset(dead), slow=slow, fail_t=fail_t)


# ---------------------------------------------------------------------------
# the transactional re-map
# ---------------------------------------------------------------------------

class RecoveryError(ScheduleError):
    """A re-map trial that must roll back (retry / shed and try again)."""


def _affected_sids(state: ClusterState, det: Detection) -> tuple[set, set]:
    """(rollback set, lost set): everything a dead core stranded or a
    straggler would delay, closed over transitive dependents that have
    not finished — re-placement only moves work later, so every
    dependent must be free to move with it."""
    tl = state.schedule
    merged = state.merged_graph()
    merged.finalize()
    seed_sids: set[int] = set()
    lost: set[int] = set()
    for sid, p in tl.placements.items():
        if p.core in det.dead:
            ft = det.fail_t.get(p.core, det.at)
            if p.end > ft + 1e-9:   # completes iff end <= fail instant
                seed_sids.add(sid)
                if p.start < ft - 1e-9:
                    lost.add(sid)   # killed in flight: work thrown away
        elif p.core in det.slow and p.start >= det.at - 1e-9:
            seed_sids.add(sid)      # evict future work from stragglers
    # transitive closure over dependency successors still in the plan
    stack = list(seed_sids)
    out = set(seed_sids)
    while stack:
        sid = stack.pop()
        for succ, _ in merged.succs[sid]:
            if succ in out or succ not in tl.placements:
                continue
            out.add(succ)
            stack.append(succ)
    return out, lost


def _replace_greedy(state: ClusterState, sids: set[int], det: Detection,
                    floor: float) -> None:
    """Re-place ``sids`` (already removed from the timeline) by greedy
    earliest-finish in topological order, onto cores that are neither
    dead nor straggling (stragglers re-enter only if nothing else is
    left). Floors: never before ``floor`` nor the app's own release."""
    tl = state.schedule
    machine = state.machine
    merged = state.merged_graph()
    merged.finalize()
    app_floor: dict[int, float] = {}
    for a in state.apps:
        f = max(a.t_admit, a.arrival.t_arrival)
        for s in a.global_sids():
            app_floor[s] = f
    cores = [c for c in range(machine.n_cores)
             if c not in det.dead and c not in det.slow]
    if not cores:
        cores = [c for c in range(machine.n_cores) if c not in det.dead]
    if not cores:
        raise RecoveryError("no surviving cores to re-map onto")

    # topological order restricted to the rollback set (preds outside
    # it are already placed history)
    indeg = {s: sum(1 for p, _ in merged.preds[s] if p in sids)
             for s in sids}
    ready_q = sorted(s for s in sids if indeg[s] == 0)
    order: list[int] = []
    heapq.heapify(ready_q)
    while ready_q:
        s = heapq.heappop(ready_q)
        order.append(s)
        for t, _ in merged.succs[s]:
            if t in indeg:
                indeg[t] -= 1
                if indeg[t] == 0:
                    heapq.heappush(ready_q, t)
    if len(order) != len(sids):
        raise RecoveryError("rollback set has a dependency cycle?")

    for sid in order:
        base = max(floor, app_floor.get(sid, 0.0))
        best = None
        for core in cores:
            ready = base
            for pred, vol in merged.preds[sid]:
                q = tl.placements[pred]
                cand = q.end + machine.comm_time(vol, q.core, core)
                if cand > ready:
                    ready = cand
            dur = merged.subtasks[sid].time_on(machine.core_types[core])
            start = tl.earliest_slot(core, ready, dur)
            fin = start + dur
            if best is None or fin < best[0]:
                best = (fin, core, start, dur)
        fin, core, start, dur = best
        tl.place(sid, core, start, start + dur)


def _tier_deadlines_ok(state: ClusterState, protect_tier: int) -> bool:
    """Does every app at/above ``protect_tier`` still make its SLA,
    per the (re-mapped) plan?"""
    tl = state.schedule
    for a in state.apps:
        if a.arrival.criticality < protect_tier:
            continue
        fin = max(tl.placements[s].end for s in a.global_sids())
        if fin > a.arrival.deadline + 1e-9:
            return False
    return True


def recover(engine: OnlineAMTHA, det: Detection,
            params: RecoveryParams | None = None) -> RecoveryReport:
    """One transactional recovery pass against ``engine``'s state.

    Rollback + re-place runs inside a Timeline transaction per attempt:
    any validation failure (or the protected tier missing deadlines)
    rewinds the cluster to exactly the pre-attempt plan, then retries
    with exponential release backoff; when retries are exhausted the
    lowest still-sheddable criticality tier is dropped and the retry
    budget resets. The last attempt commits unconditionally (a degraded
    plan beats a stranded one). Returns a :class:`RecoveryReport`."""
    par = params or RecoveryParams()
    state = engine.state
    tl = state.schedule
    if det.at > state.now:
        state.advance_to(det.at)
    report = RecoveryReport(
        t_detect=det.at, dead_cores=tuple(sorted(det.dead)),
        slow_cores=tuple(sorted(det.slow)), n_lost=0, n_rolled_back=0,
        n_replaced=0, old_makespan=tl.makespan())
    if not det.any or not state.apps:
        report.new_makespan = report.old_makespan
        return report

    rollback, lost = _affected_sids(state, det)
    report.n_lost = len(lost)
    report.n_rolled_back = len(rollback)
    if not rollback:
        report.new_makespan = report.old_makespan
        return report
    state.task_coherent = False     # partial re-maps may split tasks

    all_tiers = sorted({a.arrival.criticality for a in state.apps})
    protect_tier = all_tiers[-1]
    # with shedding off the whole workload is one indivisible "tier":
    # retries still back off, but nothing is ever dropped
    tiers = all_tiers if par.shed else [protect_tier]

    def sheddable(tier: int) -> list:
        """Unstarted apps of exactly ``tier`` (nothing in the past)."""
        out = []
        for a in state.apps:
            if a.arrival.criticality != tier:
                continue
            if all(tl.placements[s].start >= det.at - 1e-9
                   for s in a.global_sids()):
                out.append(a)
        return out

    shed_ids: list[int] = []
    shed_tier_i = 0
    delay = 0.0
    attempt = 0
    while True:
        last_chance = (attempt >= par.max_retries
                       and shed_tier_i >= len(tiers) - 1)
        # the shed set reads only pre-transaction placements, so it is
        # computed before the journal opens (a failed attempt rewinds
        # to exactly this view anyway)
        shed_apps = []
        for i in range(shed_tier_i):
            shed_apps.extend(sheddable(tiers[i]))
        shed_sids = {s for a in shed_apps for s in a.global_sids()}
        try:
            with tl.transaction():
                for sid in sorted(rollback | shed_sids):
                    if sid in tl.placements:
                        tl.remove(sid)
                _replace_greedy(state, rollback - shed_sids, det,
                                floor=det.at + delay)
                if not last_chance and not _tier_deadlines_ok(
                        state, protect_tier):
                    raise RecoveryError(
                        f"tier {protect_tier} misses deadlines")
            report.n_replaced = len(rollback - shed_sids)
            shed_ids = [a.app_id for a in shed_apps]
            break
        except ScheduleError as err:
            # the transaction context manager already rolled back
            if last_chance:
                raise               # structurally unrecoverable (no cores)
            report.notes.append(f"attempt {attempt}: {err}")
            report.retries += 1
            attempt += 1
            delay = par.retry_delay if delay == 0.0 else delay * par.backoff
            if attempt > par.max_retries and shed_tier_i < len(tiers) - 1:
                shed_tier_i += 1    # drop the next-lowest tier, reset
                attempt = 0
                delay = 0.0

    if shed_ids:
        state.drop_apps(shed_ids, t=det.at)
        report.shed_app_ids = tuple(shed_ids)
    for a in state.apps:
        a.t_est_finish = max(tl.placements[s].end for s in a.global_sids())
    if par.ga_refine and engine._can_refine():
        engine.refine_ga(seed=par.ga_seed, params=par.ga_params)
    if par.verify:
        # after drop_apps/_rebase: mid-pass the shed sids are off the
        # timeline while their apps still hold the namespace, which is
        # exactly the transient the verifier would (rightly) reject
        from ..analysis.verify import verify_cluster
        verify_cluster(state)
    report.new_makespan = state.schedule.makespan()
    return report


def recover_from_script(engine: OnlineAMTHA, script, at: float,
                        params: RecoveryParams | None = None
                        ) -> RecoveryReport:
    """Convenience: ground-truth detect at ``at``, then recover."""
    par = params or RecoveryParams()
    det = detect_script(engine.state, script, at,
                        straggle_factor=par.straggle_factor)
    return recover(engine, det, par)
