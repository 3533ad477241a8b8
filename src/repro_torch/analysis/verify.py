"""Schedule / Timeline / SimResult verifier: prove every placement.

The paper's claim is that AMTHA's predicted times match real
executions, which makes *schedule validity* — precedence, comm timing,
exclusive core occupancy — the load-bearing invariant of the whole
reproduction. ``core.schedule.validate`` raises on the first broken
invariant with a bare message; this module is the structured,
everything-at-once form the rest of the system can build on:

* every check emits a :class:`Violation` tagged with a stable ``kind``
  (``overlap``, ``precedence``, ``comm``, ``release``, ``namespace``,
  ``duration``, ``core-range``, ``task-coherence``, ``structure``,
  ``transaction``, ``finite-end``, ``fault``, ``makespan``,
  ``padding``) — mutation tests assert the verifier *names* the class
  of corruption, not merely that it throws;
* checks run to completion and report together (:class:`VerifyError`
  carries them all), so one pass over a corrupted timeline is a full
  diagnosis;
* the same invariant set applies to every result shape the system
  emits: an offline :class:`~repro_torch.core.schedule.Schedule`, the live
  transactional :class:`~repro_torch.core.timeline.Timeline` (including its
  internal array/journal consistency), a per-scenario
  :class:`~repro_torch.core.simulator.SimResult`, a whole lowered
  :class:`~repro_torch.core.lowering.ScenarioBatch` result straight off the
  device (vectorized — no per-subtask Python loop), and the
  multi-app :class:`~repro_torch.online.state.ClusterState`.

Entry points ride behind the ``verify=`` flag of
``core.registry.get_scheduler`` / ``get_simulator``,
``core.sim_engine.simulate_batch`` / ``simulate_suite``,
``OnlineAMTHA(verify=True)`` and ``RecoveryParams(verify=True)``.
``python -m repro_torch.analysis.verify [--quick] [--backend torch]``
sweeps every registered scheduler across the 8/64/256-core suites
(device-GA and fault-recovery timelines included) — the CI proof-check,
on the card by default.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.schedule import ScheduleError

#: the closed set of violation kinds the verifier emits
KINDS = ("namespace", "core-range", "duration", "overlap", "precedence",
         "comm", "release", "task-coherence", "structure", "transaction",
         "finite-end", "fault", "makespan", "padding")


@dataclass(frozen=True)
class Violation:
    """One named invariant breach. ``kind`` is from :data:`KINDS`."""

    kind: str
    message: str
    sids: tuple[int, ...] = ()
    core: int | None = None

    def __str__(self) -> str:
        where = f" [core {self.core}]" if self.core is not None else ""
        return f"{self.kind}: {self.message}{where}"


class VerifyError(ScheduleError):
    """All violations of one verification pass (subclasses
    :class:`~repro_torch.core.schedule.ScheduleError`, so existing
    ``except ScheduleError`` recovery/retry sites treat a failed proof
    exactly like a failed legacy validation)."""

    def __init__(self, violations):
        self.violations = tuple(violations)
        shown = [str(v) for v in self.violations[:20]]
        if len(self.violations) > 20:
            shown.append(f"... and {len(self.violations) - 20} more")
        super().__init__(
            f"{len(self.violations)} invariant violation(s):\n  "
            + "\n  ".join(shown))

    @property
    def kinds(self) -> set[str]:
        return {v.kind for v in self.violations}


def _lt(a: float, b: float) -> bool:
    """``a < b`` with the validator's relative tolerance."""
    return a < b - 1e-9 * max(1.0, abs(b))


def _finish(violations: list[Violation], collect: bool) -> list[Violation]:
    if collect:
        return violations
    if violations:
        raise VerifyError(violations)
    return violations


# ---------------------------------------------------------------------------
# schedules and timelines
# ---------------------------------------------------------------------------

def verify_schedule(schedule, graph, machine, *, releases=None,
                    release_floor: float = 0.0, sid_offset: int = 0,
                    allow_extra: bool = False,
                    require_task_coherence: bool = True,
                    collect: bool = False) -> list[Violation]:
    """Verify a Schedule/Timeline against one MPAHA graph.

    ``sid_offset`` shifts the graph's local sids into the schedule's
    namespace (online admissions); ``allow_extra`` permits placements
    outside that namespace (a warm-started timeline carries other
    apps' history — it still participates in the global overlap
    check). ``releases`` maps *global* sids to release floors;
    ``release_floor`` floors every sid of this graph (the admission
    instant). Raises :class:`VerifyError` unless ``collect``, in which
    case the violation list is returned.
    """
    graph.finalize()
    out: list[Violation] = []
    off = sid_offset
    want = set(range(off, off + graph.n_subtasks))
    placed = set(schedule.placements)

    missing = want - placed
    if missing:
        out.append(Violation("namespace",
                             f"unplaced subtasks: {sorted(missing)[:10]}"
                             f" ({len(missing)} total)",
                             sids=tuple(sorted(missing))))
    extra = placed - want
    if extra and not allow_extra:
        out.append(Violation("namespace",
                             f"placements outside the graph's sid "
                             f"namespace: {sorted(extra)[:10]} "
                             f"({len(extra)} total)",
                             sids=tuple(sorted(extra))))

    # per-placement checks for the graph's own sids
    for s in range(graph.n_subtasks):
        sid = off + s
        p = schedule.placements.get(sid)
        if p is None:
            continue
        if not 0 <= p.core < machine.n_cores:
            out.append(Violation("core-range",
                                 f"subtask {sid} on core {p.core} "
                                 f"(machine has {machine.n_cores})",
                                 sids=(sid,), core=p.core))
            continue
        dur = graph.subtasks[s].time_on(machine.core_types[p.core])
        if abs((p.end - p.start) - dur) > 1e-9 * max(1.0, dur):
            out.append(Violation(
                "duration",
                f"subtask {sid}: interval {p.end - p.start:.9g} != "
                f"exec time {dur:.9g} on core {p.core}",
                sids=(sid,), core=p.core))
        floor = release_floor
        if releases:
            floor = max(floor, releases.get(sid, 0.0))
        if _lt(p.start, floor):
            out.append(Violation(
                "release",
                f"subtask {sid} starts {p.start:.9g} before its "
                f"release floor {floor:.9g}",
                sids=(sid,), core=p.core))

    # global per-core exclusivity (includes any extra history)
    for core, slots in enumerate(schedule.core_slots):
        prev = None
        for (s0, e0, a) in slots:
            if _lt(e0, s0):
                out.append(Violation("structure",
                                     f"interval of {a} ends before it "
                                     f"starts ({s0:.9g} > {e0:.9g})",
                                     sids=(a,), core=core))
            if prev is not None and _lt(s0, prev[1]):
                out.append(Violation(
                    "overlap",
                    f"subtasks {prev[2]} and {a} overlap "
                    f"([{prev[0]:.9g}, {prev[1]:.9g}) vs "
                    f"[{s0:.9g}, {e0:.9g}))",
                    sids=(prev[2], a), core=core))
            prev = (s0, e0, a)

    # precedence + communication cost
    for s in range(graph.n_subtasks):
        p = schedule.placements.get(off + s)
        if p is None or not 0 <= p.core < machine.n_cores:
            continue
        for pred, vol in graph.preds[s]:
            q = schedule.placements.get(off + pred)
            if q is None or not 0 <= q.core < machine.n_cores:
                continue
            if _lt(p.start, q.end):
                out.append(Violation(
                    "precedence",
                    f"subtask {off + s} starts {p.start:.9g} before "
                    f"pred {off + pred} ends {q.end:.9g}",
                    sids=(off + s, off + pred)))
                continue
            comm = machine.comm_time(vol, q.core, p.core)
            if _lt(p.start, q.end + comm):
                out.append(Violation(
                    "comm",
                    f"subtask {off + s} starts {p.start:.9g} before "
                    f"pred {off + pred} done+comm {q.end + comm:.9g} "
                    f"(comm {comm:.3g} from core {q.core} to {p.core})",
                    sids=(off + s, off + pred)))

    if require_task_coherence:
        for task_id, sids in graph.tasks.items():
            cores = {schedule.placements[off + s].core for s in sids
                     if off + s in schedule.placements}
            if len(cores) > 1:
                out.append(Violation(
                    "task-coherence",
                    f"task {task_id} split across cores {sorted(cores)}",
                    sids=tuple(off + s for s in sids)))

    # a Timeline also proves its internal array/journal consistency
    if hasattr(schedule, "_journal"):
        out.extend(verify_timeline(schedule, collect=True))
    return _finish(out, collect)


def verify_timeline(timeline, *, collect: bool = False) -> list[Violation]:
    """Structural consistency of a :class:`~repro_torch.core.timeline.Timeline`:
    closed transaction journal, sorted/aligned per-core arrays, exact
    placements <-> interval-array bijection, availability watermark at
    or past every end (compaction keeps the frontier, so ``>=`` not
    ``==``), and per-core exclusivity."""
    out: list[Violation] = []
    if timeline.in_transaction:
        out.append(Violation(
            "transaction",
            f"open transaction journal (depth "
            f"{len(timeline._journal)}): begin() without "
            f"commit()/rollback()"))
    seen: set[int] = set()
    for c in range(timeline.n_cores):
        starts = timeline._starts[c]
        ends = timeline._ends[c]
        sids = timeline._sids[c]
        if not (len(starts) == len(ends) == len(sids)):
            out.append(Violation(
                "structure",
                f"interval arrays misaligned: {len(starts)} starts, "
                f"{len(ends)} ends, {len(sids)} sids", core=c))
            continue
        for i in range(len(starts)):
            if i and starts[i] < starts[i - 1]:
                out.append(Violation(
                    "structure",
                    f"starts not sorted at index {i} "
                    f"({starts[i]:.9g} < {starts[i - 1]:.9g})", core=c))
            if i and _lt(starts[i], ends[i - 1]):
                out.append(Violation(
                    "overlap",
                    f"subtasks {sids[i - 1]} and {sids[i]} overlap",
                    sids=(sids[i - 1], sids[i]), core=c))
            sid = sids[i]
            p = timeline.placements.get(sid)
            if p is None or p.core != c or p.start != starts[i] \
                    or p.end != ends[i]:
                out.append(Violation(
                    "structure",
                    f"interval (sid {sid}, [{starts[i]:.9g}, "
                    f"{ends[i]:.9g})) disagrees with placements[{sid}]"
                    f" = {p}", sids=(sid,), core=c))
            if sid in seen:
                out.append(Violation(
                    "structure", f"sid {sid} appears on two cores",
                    sids=(sid,), core=c))
            seen.add(sid)
        if ends and _lt(timeline._avail[c], max(ends)):
            out.append(Violation(
                "structure",
                f"availability watermark {timeline._avail[c]:.9g} "
                f"below last end {max(ends):.9g}", core=c))
    orphans = set(timeline.placements) - seen
    if orphans:
        out.append(Violation(
            "structure",
            f"placements missing from the interval arrays: "
            f"{sorted(orphans)[:10]} ({len(orphans)} total)",
            sids=tuple(sorted(orphans))))
    return _finish(out, collect)


# ---------------------------------------------------------------------------
# simulation results
# ---------------------------------------------------------------------------

def verify_sim_result(result, graph, *, sid_offset: int = 0,
                      faulty: bool = False,
                      collect: bool = False) -> list[Violation]:
    """Verify a per-scenario :class:`~repro_torch.core.simulator.SimResult`:
    every subtask has a finish time, all non-stranded finishes are
    finite, stranding only happens under faults, and ``t_exec`` is the
    max finite finish."""
    out: list[Violation] = []
    off = sid_offset
    stranded = set(getattr(result, "stranded", ()))
    if stranded and not faulty:
        out.append(Violation(
            "finite-end",
            f"fault-free run stranded subtasks {sorted(stranded)[:10]}",
            sids=tuple(sorted(stranded))))
    finite_max = 0.0
    for s in range(graph.n_subtasks):
        sid = off + s
        end = result.subtask_end.get(sid)
        if end is None:
            out.append(Violation("namespace",
                                 f"no finish time for subtask {sid}",
                                 sids=(sid,)))
            continue
        if not np.isfinite(end):
            if sid not in stranded:
                out.append(Violation(
                    "finite-end",
                    f"subtask {sid} has non-finite end {end} but is "
                    f"not marked stranded", sids=(sid,)))
            continue
        finite_max = max(finite_max, end)
    if abs(result.t_exec - finite_max) > 1e-9 * max(1.0, finite_max):
        out.append(Violation(
            "makespan",
            f"t_exec {result.t_exec:.9g} != max finite finish "
            f"{finite_max:.9g}"))
    return _finish(out, collect)


def _first_bad(mask: np.ndarray, k: int = 5) -> list[tuple]:
    """First few multi-indices where ``mask`` is True (diagnostics)."""
    idx = np.argwhere(mask)
    return [tuple(int(v) for v in row) for row in idx[:k]]


def verify_batch_result(batch, result, *, duration=None,
                        rtol: float = 1e-9,
                        collect: bool = False) -> list[Violation]:
    """Vectorized verification of a
    :class:`~repro_torch.core.sim_engine.BatchSimResult` against its lowered
    :class:`~repro_torch.core.lowering.ScenarioBatch` — no per-subtask Python
    loop, so proof-checking a device sweep costs a handful of gathers:

    * padded slots untouched (exact zeros);
    * finite ends everywhere on fault-free batches;
    * every end >= release floor + duration;
    * the in-order core edge (``batch.prev``) and every dependency
      edge (``batch.pred`` with its latency + vol/bw lag) precede the
      consumer's end;
    * under faults, per-edge/per-subtask degrade/slow factors make the
      exact bound data-dependent, so sound *lower* bounds are used
      (factors clipped at 1.0) and stranding must propagate: a finite
      end may not consume an ``inf`` producer, nor outlive its core's
      fail instant;
    * ``t_exec`` equals the max finite valid end.

    ``duration`` overrides ``batch.duration`` (the jitter hook —
    ``simulate_batch(verify=True)`` passes the jittered draws).
    ``rtol`` absorbs backend rounding (the float32 sweeps of the kernel
    and its plain version use a looser one).
    """
    out: list[Violation] = []
    b, s = batch.n_scenarios, batch.max_subtasks
    dur = np.asarray(batch.duration if duration is None else duration)
    end = np.asarray(result.subtask_end)
    if end.shape != (b, s):
        out.append(Violation(
            "structure",
            f"subtask_end shape {end.shape} != (B, S) = {(b, s)}"))
        return _finish(out, collect)
    valid = batch.valid

    def tol(bound):
        return rtol * np.maximum(1.0, np.abs(bound))

    if np.any(end[~valid] != 0.0):
        out.append(Violation(
            "padding",
            f"padded slots carry nonzero ends at "
            f"{_first_bad((end != 0.0) & ~valid)}"))

    if batch.has_faults:
        # sound lower bounds: factors can only be >= these
        sf = np.minimum(batch.slow_f, 1.0).prod(axis=2)       # (B, S)
        lf = np.minimum(batch.deg_f, 1.0).prod(axis=3)        # (B, S, P)
    else:
        sf = 1.0
        lf = 1.0
        bad = valid & ~np.isfinite(end)
        if np.any(bad):
            out.append(Violation(
                "finite-end",
                f"non-finite ends in a fault-free batch at "
                f"{_first_bad(bad)}"))
    dur_lb = dur * sf

    finite = np.isfinite(end)
    floor = np.maximum(batch.release, 0.0) + dur_lb
    bad = valid & finite & (end + tol(floor) < floor)
    if np.any(bad):
        out.append(Violation(
            "release",
            f"ends below release + duration at {_first_bad(bad)}"))

    # sentinel-padded end buffer: slot S is the always-zero source
    buf = np.concatenate([end, np.zeros((b, 1))], axis=1)
    flat = buf.reshape(-1)
    row = (np.arange(b) * (s + 1))

    prev_end = flat[batch.prev + row[:, None]]                # (B, S)
    has_prev = batch.prev < s
    bound = prev_end + dur_lb
    bad = valid & has_prev & np.isfinite(prev_end) & finite \
        & (end + tol(bound) < bound)
    if np.any(bad):
        out.append(Violation(
            "overlap",
            f"ends before predecessor-on-core + duration at "
            f"{_first_bad(bad)} (core serialization dropped)"))
    bad = valid & has_prev & np.isinf(prev_end) & finite
    if np.any(bad):
        out.append(Violation(
            "fault",
            f"finite ends after a stranded predecessor-on-core at "
            f"{_first_bad(bad)}"))

    pred_end = flat[batch.pred + row[:, None, None]]          # (B, S, P)
    real = batch.pred < s
    lag_lb = np.where(real, (batch.pred_lat + batch.pred_volbw) * lf, 0.0)
    v3 = valid[:, :, None] & real & finite[:, :, None]
    fin_pred = np.isfinite(pred_end)
    end3 = end[:, :, None]
    bound = pred_end + dur_lb[:, :, None]
    prec = v3 & fin_pred & (end3 + tol(bound) < bound)
    if np.any(prec):
        out.append(Violation(
            "precedence",
            f"ends before predecessor end + duration at "
            f"{_first_bad(prec)}"))
    bound = pred_end + lag_lb + dur_lb[:, :, None]
    comm = v3 & fin_pred & (end3 + tol(bound) < bound) & ~prec
    if np.any(comm):
        out.append(Violation(
            "comm",
            f"ends meet precedence but not the comm lag at "
            f"{_first_bad(comm)} (comm cost dropped)"))
    bad = v3 & np.isinf(pred_end)
    if np.any(bad):
        out.append(Violation(
            "fault",
            f"finite ends consuming a stranded producer at "
            f"{_first_bad(bad)}"))

    if batch.has_faults:
        bad = valid & finite & (end > batch.fail_t + tol(batch.fail_t))
        if np.any(bad):
            out.append(Violation(
                "fault",
                f"finite ends past the core's fail instant at "
                f"{_first_bad(bad)}"))

    t_ref = np.where(finite & valid, end, 0.0).max(axis=1, initial=0.0)
    bad = np.abs(np.asarray(result.t_exec) - t_ref) > tol(t_ref)
    if np.any(bad):
        out.append(Violation(
            "makespan",
            f"t_exec disagrees with max finite end for scenarios "
            f"{_first_bad(bad)}"))
    return _finish(out, collect)


# ---------------------------------------------------------------------------
# online cluster state
# ---------------------------------------------------------------------------

def verify_cluster(state, *, collect: bool = False) -> list[Violation]:
    """Verify a multi-app :class:`~repro_torch.online.state.ClusterState`:
    Timeline structural consistency, exact sid-namespace coverage
    (``remove``/``compact``/``drop_apps`` left no dangling placements
    and no app lost intervals), ``_next_sid`` bookkeeping, and the full
    schedule invariants over the merged graph with per-app arrival
    floors (coherence relaxed once recovery split a task)."""
    out: list[Violation] = list(verify_timeline(state.schedule,
                                                collect=True))
    want: set[int] = set()
    off = 0
    for a in state.apps:
        sids = set(a.global_sids())
        if a.sid_offset != off:
            out.append(Violation(
                "namespace",
                f"app {a.app_id} at sid offset {a.sid_offset}, "
                f"admission order implies {off}"))
        off += a.arrival.graph.n_subtasks
        want |= sids
    placed = set(state.schedule.placements)
    if placed != want:
        out.append(Violation(
            "namespace",
            f"timeline sids and admitted apps disagree: "
            f"missing={sorted(want - placed)[:10]} "
            f"extra={sorted(placed - want)[:10]}",
            sids=tuple(sorted(placed ^ want))))
    if state._next_sid != off:
        out.append(Violation(
            "namespace",
            f"_next_sid {state._next_sid} != live namespace size {off}"))
    if state.apps and placed == want:
        releases = {sid: a.arrival.t_arrival
                    for a in state.apps for sid in a.global_sids()}
        out.extend(verify_schedule(
            state.schedule, state.merged_graph(), state.machine,
            releases=releases,
            require_task_coherence=state.task_coherent, collect=True))
    return _finish(out, collect)


# ---------------------------------------------------------------------------
# registry wrappers (get_scheduler/get_simulator verify=True)
# ---------------------------------------------------------------------------

def verified_scheduler(entry):
    """Wrap a :class:`~repro_torch.core.registry.SchedulerEntry`'s callable so
    every schedule it emits is verified before being returned. Admission
    keywords map onto verifier parameters: ``sid_offset`` shifts the
    namespace, ``release_time`` floors every start, ``releases`` floors
    individual sids, and a ``warm_start`` timeline admits extra
    history (still covered by the global overlap check)."""
    import functools

    fn = entry.fn

    @functools.wraps(fn)
    def wrapper(graph, machine, **kwargs):
        sched = fn(graph, machine, **kwargs)
        verify_schedule(
            sched, graph, machine,
            sid_offset=kwargs.get("sid_offset", 0),
            release_floor=kwargs.get("release_time", 0.0),
            releases=kwargs.get("releases"),
            allow_extra=kwargs.get("warm_start") is not None,
            require_task_coherence=entry.task_coherent)
        return sched

    return wrapper


def verified_simulator(entry):
    """Wrap a :class:`~repro_torch.core.registry.SimulatorEntry`'s callable so
    every :class:`~repro_torch.core.simulator.SimResult` it emits is
    verified (stranding allowed only when a fault script rode along)."""
    import functools

    fn = entry.fn

    @functools.wraps(fn)
    def wrapper(graph, machine, schedule, *args, **kwargs):
        res = fn(graph, machine, schedule, *args, **kwargs)
        verify_sim_result(res, graph,
                          faulty=kwargs.get("faults") is not None)
        return res

    return wrapper


# ---------------------------------------------------------------------------
# CLI sweep: prove every scheduler on every suite (CI entry point)
# ---------------------------------------------------------------------------

def _sweep(quick: bool, seed: int, schedulers=None,
           backend: str = "cuda") -> int:
    """Run every registered scheduler across 8/64/256-core suites,
    verify every schedule, simulation result and batched sweep, the
    device-GA path and a fault-recovery timeline. ``backend`` is where
    the float32 sweeps and the GAs run: ``"cuda"`` (the kernels on the
    card) or ``"torch"`` (their plain versions on the CPU). Returns the
    number of artifacts verified; raises :class:`VerifyError` on the
    first failing one."""
    from ..core import (SynthParams, cluster_of_multicores,
                        dell_poweredge_1950, generate_app, hp_bl260c,
                        paper_suite_8core)
    from ..core.registry import SCHEDULERS, get_scheduler, get_simulator
    from ..core.sim_engine import simulate_suite
    from ..faults import random_script
    from ..online import (ArrivalParams, OnlineAMTHA, RecoveryParams,
                          generate_workload, recover_from_script)
    from ..search.ga import GAParams

    def apps(lo, hi, n, base):
        return [generate_app(SynthParams(n_tasks=(lo, hi)), seed=base + i)
                for i in range(n)]

    if quick:
        suites = [("dell-8", dell_poweredge_1950(), apps(8, 12, 3, seed)),
                  ("hp-64", hp_bl260c(), apps(20, 30, 2, seed + 10)),
                  ("cluster-256", cluster_of_multicores(n_blades=32),
                   apps(30, 40, 2, seed + 20))]
        ga_kwargs = {"params": GAParams(pop_size=8, generations=4,
                                        refine_rounds=1, refine_moves=8,
                                        backend=backend)}
    else:
        suites = [("dell-8", dell_poweredge_1950(),
                   paper_suite_8core(6, seed=seed)),
                  ("hp-64", hp_bl260c(), apps(120, 160, 2, seed + 10)),
                  ("cluster-256", cluster_of_multicores(n_blades=32),
                   apps(60, 80, 3, seed + 20))]
        ga_kwargs = {"params": GAParams(pop_size=16, generations=8,
                                        backend=backend)}
    device = "cuda" if backend == "cuda" else "cpu"

    names = sorted(schedulers or SCHEDULERS)
    n_ok = 0
    for suite, machine, graphs in suites:
        for name in names:
            fn = get_scheduler(name, verify=True)
            kwargs = ga_kwargs if name == "ga" else {}
            schedules = [fn(g, machine, **kwargs) for g in graphs]
            n_ok += len(schedules)
            # per-scenario event results + the whole-suite batched sweep
            sim = get_simulator("arrays", verify=True)
            for g, sch in zip(graphs, schedules):
                sim(g, machine, sch, contention=False)
                n_ok += 1
            simulate_suite(graphs, machine, schedules, verify=True,
                           backend="numpy")
            simulate_suite(graphs, machine, schedules, jitter=0.05,
                           verify=True, backend=backend, device=device)
            n_ok += 2
            print(f"  {suite:>12} x {name:<7} ok "
                  f"({len(graphs)} schedules)")

    # device-resident GA (8-core suite keeps the sweep minutes, not hours)
    _, machine, graphs = suites[0]
    dev = GAParams(device=True, pop_size=8, generations=3, refine_rounds=0,
                   backend=backend)
    fn = get_scheduler("ga", verify=True)
    for g in graphs:
        fn(g, machine, params=dev)
        n_ok += 1
    print(f"  {'dell-8':>12} x ga(device) ok ({len(graphs)} schedules)")

    # fault-recovery timeline: load a cluster, kill a core, recover,
    # prove the committed plan (RecoveryParams(verify=True) re-proves
    # inside recover(); the faulty batched sweep proves inf-propagation)
    eng = OnlineAMTHA(dell_poweredge_1950())
    wl = generate_workload(ArrivalParams(), n_apps=4 if quick else 8,
                           seed=seed)
    for a in wl:
        eng.admit(a)
    horizon = eng.state.schedule.makespan()
    script = random_script(8, seed=seed + 1, horizon=max(horizon, 1.0),
                           n_fail=1, n_slow=1, n_degrade=1)
    recover_from_script(eng, script, at=horizon * 0.5,
                        params=RecoveryParams(verify=True))
    verify_cluster(eng.state)
    merged = eng.state.merged_graph()
    simulate_suite([merged], eng.state.machine, [eng.state.schedule],
                   releases=[eng.state.releases()], faults=[script],
                   verify=True, backend="numpy")
    n_ok += 2
    print(f"  {'dell-8':>12} x recovery ok (1 cluster, faulty batch)")
    return n_ok


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="verify every scheduler in SCHEDULERS across the "
                    "8/64/256-core suites (+ device-GA and "
                    "fault-recovery timelines)")
    ap.add_argument("--quick", action="store_true",
                    help="small graphs / small GA budget (CI)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedulers", nargs="*", default=None,
                    help="subset of registry names (default: all)")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda",
                    help="float32 sweeps and GAs: the kernels on the card "
                         "(default) or their plain versions on the CPU")
    args = ap.parse_args(argv)
    n = _sweep(args.quick, args.seed, args.schedulers, args.backend)
    print(f"verified {n} artifacts, 0 violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
