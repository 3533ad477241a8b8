"""AMTHA — Automatic Mapping Task on Heterogeneous Architectures.

Implements Fig. 3 + §3.1–3.5 of the paper:

    Calculate rank for each task.
    While not all tasks assigned:
      1. select task t maximizing Rk(T)        (tie -> min Tavg, Eq. 3)
      2. select processor p minimizing T_p      (§3.3, LU_p / LNU_p aware)
      3. assign t to p: place each subtask in the earliest feasible gap;
         unplaceable subtasks go to LNU_p; every placement cascades
         attempts over pending LNU subtasks (§3.4)
      4. rank[t] = -1; successors whose predecessors became all-placed
         add their W_avg to their task's rank (§3.5)

Rank bookkeeping is incremental: Rk(T) (Eq. 1) is the sum of W_avg
(Eq. 2) over *ready* subtasks of T — a subtask contributes the moment its
last predecessor is placed. Because subtasks of a task form a chain, an
unassigned task's rank is carried by its first not-yet-blocked subtask;
the invariant is maintained by the same predecessor counters that drive
cascade placement.

The schedule's makespan is the paper's estimated execution time T_est.
"""

from __future__ import annotations

from collections import deque

from .machine import MachineModel
from .mpaha import AppGraph
from .schedule import Schedule


class AMTHA:
    """One-shot AMTHA, optionally *warm-started* against a partially
    occupied machine.

    ``warm_start`` — an existing :class:`Schedule` whose busy intervals
    (other applications already admitted to the cluster) constrain the
    gap search; it is mutated in place, so pass a ``copy()`` for a
    tentative evaluation. ``release_time`` — no subtask of this graph may
    start earlier (the app's arrival instant in the online setting).
    ``sid_offset`` — this graph's local subtask ids are shifted by the
    offset in the shared schedule, letting many apps coexist in one
    timeline. Defaults reproduce the paper's offline behaviour exactly.
    """

    def __init__(self, graph: AppGraph, machine: MachineModel, *,
                 warm_start: Schedule | None = None,
                 release_time: float = 0.0,
                 sid_offset: int = 0):
        if graph.n_types != machine.n_types:
            raise ValueError(
                f"graph has {graph.n_types} processor types, "
                f"machine has {machine.n_types}")
        graph.finalize()
        self.g = graph
        self.m = machine
        self.warm_start = warm_start
        self.release = float(release_time)
        self.off = int(sid_offset)
        self.type_counts = machine.type_counts()
        # cached per-subtask averages (Eq. 2)
        self.w_avg = [st.w_avg_over(self.type_counts) for st in graph.subtasks]
        self.t_avg = {t: sum(self.w_avg[s] for s in graph.tasks[t])
                      for t in graph.tasks}

    # ------------------------------------------------------------------
    def run(self) -> Schedule:
        g, m = self.g, self.m
        self.schedule = self.warm_start if self.warm_start is not None \
            else Schedule(m.n_cores)
        placed_before = len(self.schedule.placements)
        self.unplaced_preds = [len(g.preds[s]) for s in range(g.n_subtasks)]
        self.rank: dict[int, float] = {t: 0.0 for t in g.tasks}
        for s in range(g.n_subtasks):
            if self.unplaced_preds[s] == 0:
                self.rank[g.subtasks[s].task_id] += self.w_avg[s]
        self.assigned_core: dict[int, int] = {}
        # per-core LNU as insertion-ordered dicts: iteration order matches
        # the paper's pending list, removal on cascade placement is O(1)
        # (a list's .remove() made deep-LNU cascades quadratic)
        self.lnu: list[dict[int, None]] = [{} for _ in range(m.n_cores)]
        self.in_lnu: set[int] = set()

        for _ in range(len(g.tasks)):
            t = self._select_task()
            p = self._select_processor(t)
            self._assign(t, p)          # steps 3 + 4 (rank updates inline)
            self.rank[t] = -1.0
        assert len(self.schedule.placements) - placed_before == g.n_subtasks, \
            f"unplaced subtasks remain: {self.in_lnu}"
        return self.schedule

    # ---- step 1 (§3.2) -------------------------------------------------
    def _select_task(self) -> int:
        best, best_key = None, None
        for t, r in self.rank.items():
            if t in self.assigned_core:
                continue
            # max rank; tie -> min Tavg; tie -> min id (determinism)
            key = (-r, self.t_avg[t], t)
            if best_key is None or key < best_key:
                best, best_key = t, key
        assert best is not None
        return best

    # ---- step 2 (§3.3) -------------------------------------------------
    def _select_processor(self, t: int) -> int:
        best_p, best_tp = 0, float("inf")
        for p in range(self.m.n_cores):
            tp = self._predict_tp(t, p)
            if tp < best_tp - 1e-12:
                best_p, best_tp = p, tp
        return best_p

    def _predict_tp(self, t: int, p: int) -> float:
        """Tentative (non-mutating) chain placement of t on p.

        Case 1 (whole chain placeable): T_p = finish of t's last subtask.
        Case 2 (suffix blocked on an unplaced external predecessor):
        T_p = finish of the last placed subtask on p (incl. the tentative
        prefix) + sum over LNU_p ∪ blocked-suffix of exec times on p.
        """
        g, m, sch = self.g, self.m, self.schedule
        off = self.off
        ptype = m.core_types[p]
        tentative_end: dict[int, float] = {}
        blocked_from = None
        last_end = 0.0
        for k, sid in enumerate(g.tasks[t]):
            ready = self.release
            placeable = True
            for pred, vol in g.preds[sid]:
                if pred in tentative_end:                 # earlier chain subtask
                    ready = max(ready, tentative_end[pred])
                elif off + pred in sch.placements:
                    q = sch.placements[off + pred]
                    ready = max(ready, q.end + m.comm_time(vol, q.core, p))
                else:
                    placeable = False
                    break
            if not placeable:
                blocked_from = k
                break
            dur = g.subtasks[sid].time_on(ptype)
            start = sch.earliest_slot(p, max(ready, last_end), dur)
            tentative_end[sid] = start + dur
            last_end = start + dur

        if blocked_from is None:
            return last_end                                # case 1
        # case 2: LU_p finish + pending execution times
        lu_finish = max(sch.core_available(p), last_end, self.release)
        pending = sum(g.subtasks[s].time_on(ptype) for s in self.lnu[p])
        pending += sum(g.subtasks[s].time_on(ptype)
                       for s in g.tasks[t][blocked_from:])
        return lu_finish + pending

    # ---- steps 3 + 4 (§3.4, §3.5) ---------------------------------------
    def _assign(self, t: int, p: int) -> None:
        g = self.g
        self.assigned_core[t] = p
        # t's subtasks join the pending pool, then we cascade-place to a
        # fixpoint. A subtask is placeable iff all predecessors are placed
        # (the chain predecessor is part of preds, so chain order holds).
        queue: deque[int] = deque()
        for sid in g.tasks[t]:
            if self.unplaced_preds[sid] == 0:
                queue.append(sid)
            else:
                self.lnu[p][sid] = None
                self.in_lnu.add(sid)
        while queue:
            self._place(queue.popleft(), queue)

    def _place(self, sid: int, queue: deque[int]) -> None:
        g, m, sch = self.g, self.m, self.schedule
        p = self.assigned_core[g.subtasks[sid].task_id]
        ptype = m.core_types[p]
        ready = self.release
        for pred, vol in g.preds[sid]:
            q = sch.placements[self.off + pred]
            ready = max(ready, q.end + m.comm_time(vol, q.core, p))
        dur = g.subtasks[sid].time_on(ptype)
        start = sch.earliest_slot(p, ready, dur)
        sch.place(self.off + sid, p, start, start + dur)
        self._on_placed(sid, queue)

    def _on_placed(self, sid: int, queue: deque[int]) -> None:
        # §3.5: successors whose predecessors became all-placed either
        # (a) cascade-place if their task is already assigned, or
        # (b) add W_avg to their task's rank. Shared with the array
        # engine — placement identity depends on this single block.
        g = self.g
        for succ, _ in g.succs[sid]:
            self.unplaced_preds[succ] -= 1
            if self.unplaced_preds[succ] == 0:
                task = g.subtasks[succ].task_id
                if task in self.assigned_core:
                    if succ in self.in_lnu:
                        self.in_lnu.discard(succ)
                        del self.lnu[self.assigned_core[task]][succ]
                    queue.append(succ)
                else:
                    self.rank[task] += self.w_avg[succ]


def amtha_schedule(graph: AppGraph, machine: MachineModel, *,
                   warm_start: Schedule | None = None,
                   release_time: float = 0.0,
                   sid_offset: int = 0) -> Schedule:
    """Run AMTHA; ``schedule.makespan()`` is the paper's T_est. The
    keyword arguments enable incremental (online) use — see
    :class:`AMTHA`."""
    return AMTHA(graph, machine, warm_start=warm_start,
                 release_time=release_time, sid_offset=sid_offset).run()
