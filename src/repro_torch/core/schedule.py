"""Schedule representation shared by AMTHA, the baselines and the simulator.

A schedule is, per core, an ordered list of placed subtasks with
(start, end) intervals. Its makespan is the paper's ``T_est``. The
validator enforces every invariant the paper's placement rules imply —
it is the oracle for the hypothesis property tests.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .machine import MachineModel
from .mpaha import AppGraph


@dataclass
class Placement:
    sid: int
    core: int
    start: float
    end: float


@dataclass
class Schedule:
    n_cores: int
    placements: dict[int, Placement] = field(default_factory=dict)
    # per-core intervals kept sorted by start: list of (start, end, sid)
    core_slots: list[list[tuple[float, float, int]]] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.core_slots:
            self.core_slots = [[] for _ in range(self.n_cores)]

    # ---- mutation ------------------------------------------------------
    def place(self, sid: int, core: int, start: float, end: float) -> None:
        assert sid not in self.placements, f"subtask {sid} placed twice"
        self.placements[sid] = Placement(sid, core, start, end)
        bisect.insort(self.core_slots[core], (start, end, sid))

    # ---- gap search (§3.4: "a free interval between two subtasks that
    # have already been placed in p, or an interval after them") ---------
    def earliest_slot(self, core: int, ready: float, duration: float) -> float:
        """Earliest start >= ready on ``core`` with ``duration`` of free time."""
        prev_end = 0.0
        for s, e, _ in self.core_slots[core]:
            gap_start = max(prev_end, ready)
            if gap_start + duration <= s:
                return gap_start
            prev_end = max(prev_end, e)
        return max(prev_end, ready)

    def core_available(self, core: int) -> float:
        slots = self.core_slots[core]
        return slots[-1][1] if slots else 0.0

    def gaps(self, core: int, horizon: float = float("inf"),
             after: float = 0.0) -> list[tuple[float, float]]:
        """Free intervals on ``core`` within [after, horizon), last one
        open-ended to ``horizon``. The residual capacity the online
        scheduler packs newly arriving apps into."""
        out: list[tuple[float, float]] = []
        prev_end = after
        for s, e, _ in self.core_slots[core]:
            if s > prev_end + 1e-15:
                out.append((prev_end, min(s, horizon)))
            prev_end = max(prev_end, e)
        if prev_end < horizon:
            out.append((prev_end, horizon))
        return [(a, b) for a, b in out if b > a + 1e-15]

    def copy(self) -> "Schedule":
        """Deep-enough copy: placements and slot lists are fresh, so a
        tentative admission can mutate the copy without committing."""
        c = Schedule(self.n_cores)
        c.placements = dict(self.placements)
        c.core_slots = [list(slots) for slots in self.core_slots]
        return c

    def extend_sorted(self, items) -> None:
        """Bulk place: append every ``(sid, core, start, end)`` and sort
        each touched core's slot list once, instead of one
        ``bisect.insort`` per placement (the admission-commit path)."""
        touched = set()
        for sid, core, start, end in items:
            assert sid not in self.placements, f"subtask {sid} placed twice"
            self.placements[sid] = Placement(sid, core, start, end)
            self.core_slots[core].append((start, end, sid))
            touched.add(core)
        for core in touched:
            self.core_slots[core].sort()

    def merge_from(self, other: "Schedule") -> None:
        """Adopt every placement of ``other`` not already present (used to
        commit a tentatively scheduled app into the cluster timeline)."""
        if other.n_cores != self.n_cores:
            raise ValueError("core-count mismatch")
        self.extend_sorted((sid, p.core, p.start, p.end)
                           for sid, p in other.placements.items()
                           if sid not in self.placements)

    # ---- queries --------------------------------------------------------
    def makespan(self) -> float:
        if not self.placements:
            return 0.0
        return max(p.end for p in self.placements.values())

    def core_of(self, sid: int) -> int:
        return self.placements[sid].core

    def end_of(self, sid: int) -> float:
        return self.placements[sid].end

    def order_on_core(self, core: int) -> list[int]:
        return [sid for _, _, sid in self.core_slots[core]]

    def assignment(self) -> dict[int, int]:
        return {sid: p.core for sid, p in self.placements.items()}


class ScheduleError(AssertionError):
    pass


def validate(schedule: Schedule, graph: AppGraph, machine: MachineModel,
             require_task_coherence: bool = True) -> None:
    """All invariants a legal AMTHA/HEFT schedule must satisfy:

    1. every subtask placed exactly once, on a real core;
    2. duration matches the subtask time on that core's processor type;
    3. no two subtasks overlap on a core;
    4. precedence + communication: start(St) >= end(pred) + comm_time
       (0 if co-located) for every predecessor edge, including the
       intra-task chain;
    5. all subtasks of one task are on the same core (AMTHA assigns
       *tasks* to processors — §3 step 3). HEFT/ETF baselines map
       subtasks independently, so they validate with
       ``require_task_coherence=False``.
    """
    placed = set(schedule.placements)
    want = set(range(graph.n_subtasks))
    if placed != want:
        raise ScheduleError(f"missing={want - placed} extra={placed - want}")

    for sid, p in schedule.placements.items():
        if not (0 <= p.core < machine.n_cores):
            raise ScheduleError(f"subtask {sid} on bad core {p.core}")
        dur = graph.subtasks[sid].time_on(machine.core_types[p.core])
        if abs((p.end - p.start) - dur) > 1e-9 * max(1.0, dur):
            raise ScheduleError(
                f"subtask {sid}: duration {p.end - p.start} != {dur}")

    all_slots = schedule.core_slots    # one view build (Timeline property)
    for core in range(machine.n_cores):
        slots = all_slots[core]
        for (s0, e0, a), (s1, e1, b) in zip(slots, slots[1:]):
            if e0 > s1 + 1e-9:
                raise ScheduleError(f"overlap on core {core}: {a} and {b}")

    for sid in range(graph.n_subtasks):
        p = schedule.placements[sid]
        for pred, vol in graph.preds[sid]:
            q = schedule.placements[pred]
            comm = machine.comm_time(vol, q.core, p.core)
            if p.start + 1e-9 < q.end + comm:
                raise ScheduleError(
                    f"subtask {sid} starts {p.start} before pred {pred} "
                    f"done+comm {q.end + comm}")

    if require_task_coherence:
        for task_id, sids in graph.tasks.items():
            cores = {schedule.placements[s].core for s in sids}
            if len(cores) != 1:
                raise ScheduleError(f"task {task_id} split across cores {cores}")
