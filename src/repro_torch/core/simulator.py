"""Discrete-event execution of a static schedule -> T_exec.

Stands in for the paper's real multicore runs (see DESIGN.md §6).
Semantics:

* each core executes the subtasks assigned to it **in the schedule's
  order** (a static mapping fixes the order — §3 of the paper);
* a subtask starts when the core reaches it AND every predecessor's data
  has arrived;
* data transfer starts eagerly when the producer finishes. Transfers
  through the *same shared memory level instance* (e.g. the one L2 a
  core pair shares, the one RAM bus of a blade, the one inter-blade
  link) share its bandwidth **fluidly** — this is the contention that
  the paper identifies as its error source ("as the volume of
  communications ... increases, so does the error as a function of the
  available cache");
* optional multiplicative compute jitter models OS noise.

With ``contention=False`` and ``jitter=0`` the simulation reproduces the
analytic times exactly, so ``T_exec == T_est`` — a property test anchors
this (the predictor and the executor agree on the semantics).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .machine import MachineModel
from .mpaha import AppGraph
from .schedule import Schedule


@dataclass
class SimResult:
    t_exec: float
    subtask_end: dict[int, float]
    # sids that never completed because a fault stranded them (their
    # subtask_end entries are inf); empty on healthy runs
    stranded: tuple[int, ...] = ()

    def dif_rel(self, t_est: float) -> float:
        """Paper Eq. (4): %Dif_rel = (T_exec - T_est)/T_exec * 100.

        An empty or degenerate scenario (``t_exec == 0``) has nothing
        to mispredict — the error is defined as 0 instead of dividing
        by zero."""
        if self.t_exec == 0.0:
            return 0.0
        return (self.t_exec - t_est) / self.t_exec * 100.0


def simulate(graph: AppGraph, machine: MachineModel, schedule: Schedule,
             contention: bool = True, jitter: float = 0.0,
             seed: int = 0,
             releases: dict[int, float] | None = None,
             faults=None) -> SimResult:
    """``releases`` is the event-driven injection hook for the online
    subsystem: ``releases[sid] = t`` holds subtask ``sid`` back until
    simulated time ``t`` (an application arriving mid-simulation is just
    its subtasks carrying ``t = arrival``). Release events enter the same
    event heap as everything else, so cores that idle past an injection
    instant pick the new work up in order.

    ``faults`` — a fault script (anything with ``FaultScript``'s views,
    see :func:`~repro_torch.core.lowering.lower_faults`) or a prelowered
    :class:`~repro_torch.core.lowering.FaultArrays` replayed during the run:
    a failed core strands everything that has not finished by the fail
    instant (in-flight work is killed), a slowed core scales durations
    by the factor in effect at each subtask's start, and a degraded
    link scales latency and inverse bandwidth at each transfer's start.
    Stranded subtasks come back with ``inf`` end times instead of a
    deadlock error."""
    from .lowering import lower_faults

    graph.finalize()
    rng = np.random.default_rng(seed)
    fa = lower_faults(machine.n_cores, faults)
    fail_t = fa.fail_t.tolist() if fa is not None else None
    slow_ev = fa.slow if fa is not None else None
    degrade_ev = fa.degrade if fa is not None else None

    core_order = [schedule.order_on_core(c) for c in range(machine.n_cores)]
    core_pos = [0] * machine.n_cores            # next index into core_order
    core_busy_until = [0.0] * machine.n_cores
    arrivals_pending = [len(graph.preds[s]) for s in range(graph.n_subtasks)]
    done: dict[int, float] = {}

    # fluid transfers: tid -> [bytes_left, instance_key, dst_sid, latency_left]
    transfers: dict[int, list] = {}
    per_instance: dict[tuple, set[int]] = {}
    next_tid = 0

    # event heap: (time, seq, kind, payload). Fluid transfers are handled
    # by re-deriving the next completion each loop iteration.
    events: list[tuple[float, int, str, int]] = []
    seq = 0
    now = 0.0

    def exec_time(sid: int, core: int) -> float:
        base = graph.subtasks[sid].time_on(machine.core_types[core])
        if slow_ev is not None:
            # slowdown sampled at the start instant, factors composed
            # in script order (the bit-identity contract of the script)
            for t_ev, f_ev in slow_ev[core]:
                if now >= t_ev:
                    base *= f_ev
        if jitter > 0.0:
            base *= float(np.exp(rng.normal(0.0, jitter)))
        return base

    def try_start(core: int) -> None:
        """Start the next in-order subtask on ``core`` if it is ready."""
        nonlocal seq
        if core_pos[core] >= len(core_order[core]):
            return
        if fail_t is not None and now >= fail_t[core]:
            return                          # dead core: strand the rest
        sid = core_order[core][core_pos[core]]
        if arrivals_pending[sid] > 0 or core_busy_until[core] > now + 1e-15:
            return
        dur = exec_time(sid, core)
        core_pos[core] += 1
        core_busy_until[core] = now + dur
        heapq.heappush(events, (now + dur, seq, "done", sid))
        seq += 1

    def arrive(sid_dst: int) -> None:
        arrivals_pending[sid_dst] -= 1
        if arrivals_pending[sid_dst] == 0:
            core = schedule.core_of(sid_dst)
            try_start(core)

    def start_transfer(src: int, dst: int, vol: float) -> None:
        nonlocal next_tid
        a, b = schedule.core_of(src), schedule.core_of(dst)
        if a == b or vol <= 0.0:
            arrive(dst)
            return
        # link degradation sampled at the transfer's start; multiplying
        # by the neutral 1.0 is exact, so fault-free runs are unchanged
        lp = 1.0
        if degrade_ev:
            steps = degrade_ev.get((a, b) if a < b else (b, a))
            if steps:
                for t_ev, f_ev in steps:
                    if now >= t_ev:
                        lp *= f_ev
        lvl_idx = machine.level_index(a, b)
        lvl = machine.levels[lvl_idx]
        if not contention:
            # analytic: fixed latency + vol/bw, no sharing
            nonlocal seq
            heapq.heappush(events,
                           (now + lvl.latency * lp
                            + vol / lvl.bandwidth * lp,
                            seq, "arrive", dst))
            seq += 1
            return
        inst = (lvl_idx, machine.locations[a][:lvl_idx],
                machine.locations[b][:lvl_idx])
        # latency is serialized into the fluid phase as extra 'distance';
        # a degraded link carries lp x the latency and lp x the volume
        # (volume inflation == bandwidth division, fixed at start)
        transfers[next_tid] = [vol * lp, inst, dst, lvl.latency * lp]
        per_instance.setdefault(inst, set()).add(next_tid)
        next_tid += 1

    def transfer_rate(inst: tuple) -> float:
        lvl = machine.levels[inst[0]]
        return lvl.bandwidth / max(1, len(per_instance.get(inst, ())))

    def next_transfer_completion() -> tuple[float, int] | None:
        best = None
        for tid, (bytes_left, inst, _dst, lat) in transfers.items():
            t = now + lat + bytes_left / transfer_rate(inst)
            if best is None or t < best[0]:
                best = (t, tid)
        return best

    def advance_transfers(dt: float) -> None:
        for tid, rec in transfers.items():
            lat_used = min(rec[3], dt)
            rec[3] -= lat_used
            fluid_dt = dt - lat_used
            if fluid_dt > 0:
                rec[0] -= fluid_dt * transfer_rate(rec[1])

    # injection hook: a pending release counts as one more predecessor
    # whose "data" arrives at the release instant
    if releases:
        for sid, t_rel in releases.items():
            if t_rel > 0.0:
                arrivals_pending[sid] += 1
                heapq.heappush(events, (float(t_rel), seq, "arrive", sid))
                seq += 1

    # bootstrap: subtasks with no preds can start
    for core in range(machine.n_cores):
        try_start(core)

    while events or transfers:
        ev = events[0] if events else None
        tr = next_transfer_completion()
        if tr is not None and (ev is None or tr[0] < ev[0]):
            t_next, tid = tr
            advance_transfers(t_next - now)
            now = t_next
            rec = transfers.pop(tid)
            per_instance[rec[1]].discard(tid)
            arrive(rec[2])
        else:
            assert ev is not None
            t_next, _, kind, payload = heapq.heappop(events)
            advance_transfers(t_next - now)
            now = t_next
            if kind == "done":
                sid = payload
                core = schedule.core_of(sid)
                if fail_t is not None and now > fail_t[core]:
                    # the core died while this subtask was in flight:
                    # the result is lost — no completion, no transfers,
                    # and the dead core starts nothing else
                    continue
                done[sid] = now
                for succ, vol in graph.succs[sid]:
                    start_transfer(sid, succ, vol)
                try_start(core)
            else:   # analytic arrival
                arrive(payload)
        # a core may have become free exactly when data arrived earlier
        for core in range(machine.n_cores):
            if core_busy_until[core] <= now + 1e-15:
                try_start(core)

    if len(done) != graph.n_subtasks:
        missing = set(range(graph.n_subtasks)) - set(done)
        if fa is None:
            raise RuntimeError(f"simulation deadlock; unfinished: {missing}")
        # faults legitimately strand work (dead core, or downstream of
        # one); makespan is over finished subtasks, stranded get inf
        stranded = tuple(sorted(missing))
        for s in stranded:
            done[s] = float("inf")
        return SimResult(max((done[s] for s in done if s not in missing),
                             default=0.0), done, stranded)
    return SimResult(max(done.values(), default=0.0), done)
