"""Array-backed timeline: the scheduling engine's hot data structure.

``Schedule`` keeps one list of ``(start, end, sid)`` tuples per core and
re-scans it linearly on every gap query; tentative admissions snapshot
the whole thing with ``copy()``. ``Timeline`` replaces both costs:

* **structure-of-arrays** storage — per-core parallel lists of starts,
  ends and sids kept sorted by start, with a cached per-core
  ``core_available`` so the common "append at the end" placement is
  O(log slots) instead of O(slots);
* **binary-search gap lookup** — ``earliest_slot`` bisects to the first
  interval that can matter for ``ready`` and scans only the gaps after
  it, so the placement inner loop drops from O(slots) to O(log slots)
  when the request lands at/after the frontier (the overwhelmingly
  common case for online admissions);
* a **transaction journal** — ``begin()`` / ``commit()`` / ``rollback()``
  record each placement made inside the transaction, so a tentative
  admission or a ``predict()`` what-if rewinds in O(ops made) instead of
  deep-copying the entire cluster timeline up front.

The interface is a superset of :class:`~repro_torch.core.schedule.Schedule`
(``place``, ``earliest_slot``, ``core_available``, ``gaps``, ``copy``,
``merge_from``, ``extend_sorted``, the query helpers, and a lazily built
``core_slots`` view), so the validator, the simulator and the seed
``AMTHA`` all run on it unchanged.

Invariant: intervals on one core never overlap (everything placed here
comes out of a gap search), which is what makes ends monotone per core
and the bisect shortcut exact.
"""

from __future__ import annotations

from bisect import bisect_right
from contextlib import contextmanager

from .schedule import Placement, Schedule


class Timeline:
    """Sorted per-core interval arrays + journaled mutation."""

    __slots__ = ("n_cores", "placements", "_starts", "_ends", "_sids",
                 "_avail", "_journal")

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.placements: dict[int, Placement] = {}
        self._starts: list[list[float]] = [[] for _ in range(n_cores)]
        self._ends: list[list[float]] = [[] for _ in range(n_cores)]
        self._sids: list[list[int]] = [[] for _ in range(n_cores)]
        self._avail: list[float] = [0.0] * n_cores
        # stack of op lists; each op is tagged:
        #   ("add", sid, core, index, prev_avail)            — place
        #   ("del", sid, core, index, start, end, prev_avail) — remove
        self._journal: list[list[tuple]] = []

    # ---- mutation ------------------------------------------------------
    def place(self, sid: int, core: int, start: float, end: float) -> None:
        assert sid not in self.placements, f"subtask {sid} placed twice"
        starts = self._starts[core]
        idx = bisect_right(starts, start)
        starts.insert(idx, start)
        self._ends[core].insert(idx, end)
        self._sids[core].insert(idx, sid)
        self.placements[sid] = Placement(sid, core, start, end)
        prev = self._avail[core]
        if end > prev:
            self._avail[core] = end
        if self._journal:
            self._journal[-1].append(("add", sid, core, idx, prev))

    def remove(self, sid: int) -> Placement:
        """Unplace ``sid`` (the recovery rollback primitive). Journaled
        like ``place``, so a transaction that removes intervals and
        re-places them elsewhere rewinds cleanly on ``rollback``."""
        p = self.placements.pop(sid)
        starts = self._starts[p.core]
        sids = self._sids[p.core]
        idx = bisect_right(starts, p.start) - 1
        while sids[idx] != sid:        # zero-length ties share a start
            idx -= 1
        del starts[idx]
        del self._ends[p.core][idx]
        del sids[idx]
        prev = self._avail[p.core]
        ends = self._ends[p.core]
        # ends are monotone per core (no overlap), so the frontier is
        # the last end of what remains
        self._avail[p.core] = ends[-1] if ends else 0.0
        if self._journal:
            self._journal[-1].append(("del", sid, p.core, idx,
                                      p.start, p.end, prev))
        return p

    def extend_sorted(self, items) -> None:
        """Bulk place: append every ``(sid, core, start, end)`` and sort
        each touched core once, instead of one sorted-insert per
        placement. Not allowed inside a transaction (the re-sort would
        invalidate journaled indices)."""
        assert not self._journal, "bulk place inside a transaction"
        touched = set()
        for sid, core, start, end in items:
            assert sid not in self.placements, f"subtask {sid} placed twice"
            self.placements[sid] = Placement(sid, core, start, end)
            self._starts[core].append(start)
            self._ends[core].append(end)
            self._sids[core].append(sid)
            touched.add(core)
        for c in touched:
            rows = sorted(zip(self._starts[c], self._ends[c], self._sids[c]))
            self._starts[c] = [r[0] for r in rows]
            self._ends[c] = [r[1] for r in rows]
            self._sids[c] = [r[2] for r in rows]
            if rows:
                self._avail[c] = max(self._avail[c], rows[-1][1])

    def merge_from(self, other) -> None:
        """Adopt every placement of ``other`` not already present (one
        bulk sort per touched core — the batched commit path)."""
        if other.n_cores != self.n_cores:
            raise ValueError("core-count mismatch")
        self.extend_sorted(
            (sid, p.core, p.start, p.end)
            for sid, p in other.placements.items()
            if sid not in self.placements)

    # ---- transactions --------------------------------------------------
    def begin(self) -> None:
        """Open a transaction: every ``place`` until ``commit`` or
        ``rollback`` is journaled. Transactions nest; an inner commit
        folds its ops into the enclosing journal."""
        self._journal.append([])

    def commit(self) -> None:
        ops = self._journal.pop()
        if self._journal:
            self._journal[-1].extend(ops)

    def rollback(self) -> None:
        """Undo the innermost transaction in O(ops made). Ops are undone
        LIFO, so each journaled index is exact at undo time."""
        for op in reversed(self._journal.pop()):
            if op[0] == "add":
                _, sid, core, idx, prev_avail = op
                del self._starts[core][idx]
                del self._ends[core][idx]
                del self._sids[core][idx]
                del self.placements[sid]
            else:                               # "del": re-insert
                _, sid, core, idx, start, end, prev_avail = op
                self._starts[core].insert(idx, start)
                self._ends[core].insert(idx, end)
                self._sids[core].insert(idx, sid)
                self.placements[sid] = Placement(sid, core, start, end)
            self._avail[core] = prev_avail

    @property
    def in_transaction(self) -> bool:
        return bool(self._journal)

    @contextmanager
    def transaction(self, commit: bool = True):
        """Structural transaction: ``with tl.transaction(): ...`` makes
        rollback-on-exception impossible to forget — the journal always
        closes, whatever the body raises. ``commit=False`` is the
        what-if shape (``predict``): run the body against the live
        timeline, read the outcome inside the block, rewind on exit."""
        self.begin()
        try:
            yield self
        except BaseException:
            self.rollback()
            raise
        else:
            if commit:
                self.commit()
            else:
                self.rollback()

    # ---- horizon compaction -------------------------------------------
    def compact(self, retire, remap=None) -> dict[int, Placement]:
        """Drop every placement in ``retire`` and rename the survivors
        through ``remap`` (old sid -> new sid; identity where absent) —
        the bounded-state primitive: one filtered rebuild per core, so
        a long-running timeline stays O(live work). ``_avail`` keeps the
        true frontier (a core *was* busy until its retired work ended,
        and retirement must not open slots in the past). Not allowed in
        a transaction (journaled indices would dangle). Returns the
        retired placements (for the caller's utilization accounting)."""
        assert not self._journal, "compact inside a transaction"
        retire = set(retire)
        remap = remap or {}
        retired: dict[int, Placement] = {}
        for c in range(self.n_cores):
            keep = [(s, e, sid) for s, e, sid
                    in zip(self._starts[c], self._ends[c], self._sids[c])
                    if sid not in retire]
            self._starts[c] = [s for s, _, _ in keep]
            self._ends[c] = [e for _, e, _ in keep]
            self._sids[c] = [remap.get(sid, sid) for _, _, sid in keep]
        placements: dict[int, Placement] = {}
        for sid, p in self.placements.items():
            if sid in retire:
                retired[sid] = p
            else:
                nsid = remap.get(sid, sid)
                placements[nsid] = Placement(nsid, p.core, p.start, p.end)
        self.placements = placements
        return retired

    # ---- gap search ----------------------------------------------------
    def earliest_slot(self, core: int, ready: float, duration: float) -> float:
        """Earliest start >= ready on ``core`` with ``duration`` free.

        Bisects to the last interval starting at/before ``ready`` (its
        end bounds every earlier end because intervals don't overlap),
        then scans only the gaps from there — O(log slots) when the
        request lands at or after the frontier."""
        starts = self._starts[core]
        ends = self._ends[core]
        i = bisect_right(starts, ready)
        prev = ends[i - 1] if i else 0.0
        n = len(starts)
        while i < n:
            gap_start = prev if prev > ready else ready
            if gap_start + duration <= starts[i]:
                return gap_start
            prev = ends[i]
            i += 1
        return prev if prev > ready else ready

    def core_available(self, core: int) -> float:
        return self._avail[core]

    def gaps(self, core: int, horizon: float = float("inf"),
             after: float = 0.0) -> list[tuple[float, float]]:
        """Free intervals on ``core`` within [after, horizon), last one
        open-ended to ``horizon`` (same contract as ``Schedule.gaps``)."""
        out: list[tuple[float, float]] = []
        prev_end = after
        for s, e in zip(self._starts[core], self._ends[core]):
            if s > prev_end + 1e-15:
                out.append((prev_end, min(s, horizon)))
            prev_end = max(prev_end, e)
        if prev_end < horizon:
            out.append((prev_end, horizon))
        return [(a, b) for a, b in out if b > a + 1e-15]

    # ---- copies / conversions -----------------------------------------
    def copy(self) -> "Timeline":
        c = Timeline(self.n_cores)
        c.placements = dict(self.placements)
        c._starts = [list(x) for x in self._starts]
        c._ends = [list(x) for x in self._ends]
        c._sids = [list(x) for x in self._sids]
        c._avail = list(self._avail)
        return c

    @classmethod
    def from_schedule(cls, schedule: Schedule) -> "Timeline":
        t = cls(schedule.n_cores)
        for core, slots in enumerate(schedule.core_slots):
            t._starts[core] = [s for s, _, _ in slots]
            t._ends[core] = [e for _, e, _ in slots]
            t._sids[core] = [sid for _, _, sid in slots]
            if slots:
                t._avail[core] = max(e for _, e, _ in slots)
        t.placements = dict(schedule.placements)
        return t

    def to_schedule(self) -> Schedule:
        s = Schedule(self.n_cores)
        s.placements = dict(self.placements)
        s.core_slots = [list(zip(self._starts[c], self._ends[c],
                                 self._sids[c]))
                        for c in range(self.n_cores)]
        return s

    # ---- queries (Schedule-compatible) --------------------------------
    @property
    def core_slots(self) -> list[list[tuple[float, float, int]]]:
        """Schedule-shaped view, built on demand (validator/metrics
        path, not the hot path)."""
        return [list(zip(self._starts[c], self._ends[c], self._sids[c]))
                for c in range(self.n_cores)]

    def makespan(self) -> float:
        # max frontier, not max placement end: after horizon compaction
        # the placements may be gone while the cores were still busy up
        # to the watermark — the frontier is the honest answer (and it
        # is 0.0 on a genuinely fresh timeline)
        return max(self._avail, default=0.0)

    def core_of(self, sid: int) -> int:
        return self.placements[sid].core

    def end_of(self, sid: int) -> float:
        return self.placements[sid].end

    def order_on_core(self, core: int) -> list[int]:
        return list(self._sids[core])

    def assignment(self) -> dict[int, int]:
        return {sid: p.core for sid, p in self.placements.items()}
