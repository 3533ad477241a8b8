"""HEFT baseline (Topcuoglu et al. 2002 — the paper's ref [9]).

The paper positions AMTHA against known list-scheduling mappers; HEFT is
the canonical one. We run it on the *same* MPAHA graph so the makespan
comparison in ``benchmarks/vs_heft.py`` is apples-to-apples. HEFT maps
subtasks independently (no task-coherence constraint) with upward ranks
and insertion-based earliest-finish-time core selection.
"""

from __future__ import annotations

from .machine import MachineModel
from .mpaha import AppGraph
from .schedule import Schedule


def _avg_comm_time(machine: MachineModel, volume: float) -> float:
    """Mean comm time over all ordered core pairs (incl. zero same-core)."""
    n = machine.n_cores
    total = 0.0
    for a in range(n):
        for b in range(n):
            if a != b:
                total += machine.comm_time(volume, a, b)
    return total / (n * n)


def heft_schedule(graph: AppGraph, machine: MachineModel) -> Schedule:
    graph.finalize()
    type_counts = machine.type_counts()
    w = [st.w_avg_over(type_counts) for st in graph.subtasks]

    # cache avg comm per distinct volume (volumes repeat heavily)
    comm_cache: dict[float, float] = {}

    def avg_comm(vol: float) -> float:
        if vol not in comm_cache:
            comm_cache[vol] = _avg_comm_time(machine, vol) if vol > 0 else 0.0
        return comm_cache[vol]

    # upward rank via reverse topological order
    n = graph.n_subtasks
    order = _topo_order(graph)
    rank_u = [0.0] * n
    for sid in reversed(order):
        best = 0.0
        for succ, vol in graph.succs[sid]:
            best = max(best, avg_comm(vol) + rank_u[succ])
        rank_u[sid] = w[sid] + best

    schedule = Schedule(machine.n_cores)
    for sid in sorted(range(n), key=lambda s: -rank_u[s]):
        best = None     # (eft, start, core)
        for p in range(machine.n_cores):
            ready = 0.0
            for pred, vol in graph.preds[sid]:
                q = schedule.placements[pred]
                ready = max(ready, q.end + machine.comm_time(vol, q.core, p))
            dur = graph.subtasks[sid].time_on(machine.core_types[p])
            start = schedule.earliest_slot(p, ready, dur)
            if best is None or start + dur < best[0] - 1e-12:
                best = (start + dur, start, p)
        assert best is not None
        schedule.place(sid, best[2], best[1], best[0])
    return schedule


def etf_schedule(graph: AppGraph, machine: MachineModel) -> Schedule:
    """Earliest-Task-First greedy: repeatedly place the (ready subtask,
    core) pair with the earliest start time. A weaker baseline than HEFT."""
    graph.finalize()
    schedule = Schedule(machine.n_cores)
    unplaced_preds = [len(graph.preds[s]) for s in range(graph.n_subtasks)]
    ready = {s for s in range(graph.n_subtasks) if unplaced_preds[s] == 0}
    while ready:
        best = None     # (start, eft, sid, core)
        for sid in ready:
            for p in range(machine.n_cores):
                t_ready = 0.0
                for pred, vol in graph.preds[sid]:
                    q = schedule.placements[pred]
                    t_ready = max(t_ready,
                                  q.end + machine.comm_time(vol, q.core, p))
                dur = graph.subtasks[sid].time_on(machine.core_types[p])
                start = schedule.earliest_slot(p, t_ready, dur)
                key = (start, start + dur, sid, p)
                if best is None or key < best:
                    best = key
        start, eft, sid, p = best
        schedule.place(sid, p, start, eft)
        ready.discard(sid)
        for succ, _ in graph.succs[sid]:
            unplaced_preds[succ] -= 1
            if unplaced_preds[succ] == 0:
                ready.add(succ)
    return schedule


def _topo_order(graph: AppGraph) -> list[int]:
    indeg = [len(graph.preds[s]) for s in range(graph.n_subtasks)]
    stack = [s for s in range(graph.n_subtasks) if indeg[s] == 0]
    out: list[int] = []
    while stack:
        s = stack.pop()
        out.append(s)
        for t, _ in graph.succs[s]:
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
    return out
