"""Array-backed AMTHA engine: the vectorized scheduler hot path.

Same algorithm as :class:`~repro_torch.core.amtha.AMTHA` (Fig. 3, §3.1–3.5),
same schedules bit-for-bit — the equivalence tests pin placement
identity — but the three hot loops are rebuilt around arrays:

* **step 2 (§3.3)** — the ``(n_subtasks × n_types)`` exec-time matrix
  and the per-pair comm latency/bandwidth matrices are precomputed as
  NumPy arrays, so the tentative chain walk evaluates ready-time vectors
  for *all cores at once*; only the data-dependent gap probe stays
  per-core, and that probe is the Timeline's O(log slots) bisect;
* **step 1 (§3.2)** — task selection runs off a lazy max-heap keyed by
  the paper's ``(-Rk, Tavg, id)`` tuple instead of a linear scan of
  every task per iteration;
* **steps 3–4 (§3.4–3.5)** — inherited unchanged from the seed (single
  source of truth for the cascade), but running on a
  :class:`~repro_torch.core.timeline.Timeline`, whose gap search is
  logarithmic and whose transaction journal makes online what-ifs
  O(ops) to rewind.

Floating-point discipline: every reduction that feeds a comparison
(ranks, ready maxima, the case-2 pending sums, ``lat + vol / bw``)
reproduces the seed's operation order and associativity exactly, so
tie-breaks — including the 1e-12 processor-selection scan — can never
diverge.
"""

from __future__ import annotations

from heapq import heappop, heappush

import numpy as np

from . import lowering
from .amtha import AMTHA
from .machine import MachineModel
from .mpaha import AppGraph
from .schedule import Schedule
from .timeline import Timeline


class _HeapRank(dict):
    """Rank dict that mirrors every live update into a lazy max-heap.

    The seed mutates ``rank`` in two ways — ``+= w_avg`` when a subtask
    becomes ready (§3.5) and ``= -1`` on assignment — so intercepting
    ``__setitem__`` catches every change without touching the inherited
    cascade code. Stale heap entries are skipped at pop time."""

    __slots__ = ("heap", "t_avg")

    def __init__(self, t_avg: dict[int, float]):
        super().__init__()
        self.heap: list[tuple[float, float, int]] = []
        self.t_avg = t_avg

    def __setitem__(self, t: int, r: float) -> None:
        dict.__setitem__(self, t, r)
        if r >= 0.0:
            heappush(self.heap, (-r, self.t_avg[t], t))


class ArrayAMTHA(AMTHA):
    """Drop-in AMTHA with vectorized processor selection on a Timeline."""

    def __init__(self, graph: AppGraph, machine: MachineModel, *,
                 warm_start: Timeline | Schedule | None = None,
                 release_time: float = 0.0,
                 sid_offset: int = 0):
        super().__init__(graph, machine, warm_start=warm_start,
                         release_time=release_time, sid_offset=sid_offset)
        self.W = lowering.graph_arrays(graph).exec_type             # (S, T)
        self.Wc = lowering.exec_matrix(graph, machine)              # (S, C)
        self.lat, self.bw = lowering.comm_matrices(machine)
        # row-list views of the same matrices for the scalar chain walk:
        # identical IEEE-754 values, but plain-float arithmetic instead
        # of np.float64 scalar ops (which cost ~5x per operation)
        self._w_rows = self.W.tolist()
        self._wc_rows = self.Wc.tolist()
        self._lat_rows = self.lat.tolist()
        self._bw_rows = self.bw.tolist()

    # ------------------------------------------------------------------
    def run(self) -> Timeline:
        g, m = self.g, self.m
        sch = self.warm_start
        writeback = None
        if sch is None:
            sch = Timeline(m.n_cores)
        elif isinstance(sch, Schedule):
            # honor the seed's warm-start contract (mutated in place):
            # run on an array view, then write the new placements back
            writeback = sch
            sch = Timeline.from_schedule(sch)
        self.schedule = sch
        placed_before = len(sch.placements)
        self.unplaced_preds = [len(g.preds[s]) for s in range(g.n_subtasks)]
        self.rank = _HeapRank(self.t_avg)
        for t in g.tasks:
            self.rank[t] = 0.0
        for s in range(g.n_subtasks):
            if self.unplaced_preds[s] == 0:
                self.rank[g.subtasks[s].task_id] += self.w_avg[s]
        self.assigned_core = {}
        self.lnu = [{} for _ in range(m.n_cores)]
        self.in_lnu = set()

        for _ in range(len(g.tasks)):
            t = self._select_task()
            p = self._select_processor(t)
            self._assign(t, p)          # inherited cascade (§3.4, §3.5)
            self.rank[t] = -1.0
        assert len(sch.placements) - placed_before == g.n_subtasks, \
            f"unplaced subtasks remain: {self.in_lnu}"
        if writeback is not None:
            writeback.extend_sorted(
                (sid, p.core, p.start, p.end)
                for sid, p in sch.placements.items()
                if sid not in writeback.placements)
        return sch

    # ---- step 1 (§3.2): lazy heap -------------------------------------
    def _select_task(self) -> int:
        heap = self.rank.heap
        while heap:
            neg_r, _, t = heap[0]
            heappop(heap)
            if t not in self.assigned_core and self.rank[t] == -neg_r:
                return t
        raise AssertionError("no selectable task left")

    # ---- step 2 (§3.3): all cores at once -----------------------------
    def _select_processor(self, t: int) -> int:
        tp = self._tp_all(t)
        best_p, best_tp = 0, float("inf")
        for p, v in enumerate(tp):      # seed's exact tolerance scan
            if v < best_tp - 1e-12:
                best_p, best_tp = p, v
        return best_p

    def _tp_all(self, t: int) -> list[float]:
        """T_p over every core — the seed's ``_predict_tp`` evaluated
        for all cores in one chain walk. The blocked/placeable split is
        core-independent (it only asks whether predecessors are placed),
        so one walk covers every core; only the gap probe is per-core."""
        g, m, sch = self.g, self.m, self.schedule
        off = self.off
        C = m.n_cores
        rel = self.release
        placements = sch.placements
        tentative_end: dict[int, list[float]] = {}
        blocked_from = None
        last_end = [0.0] * C
        chain = g.tasks[t]
        cores = range(C)
        for k, sid in enumerate(chain):
            ready = [rel] * C
            placeable = True
            for pred, vol in g.preds[sid]:
                te = tentative_end.get(pred)
                if te is not None:                    # earlier chain subtask
                    for p in cores:
                        if te[p] > ready[p]:
                            ready[p] = te[p]
                elif off + pred in placements:
                    q = placements[off + pred]
                    qe = q.end
                    lrow = self._lat_rows[q.core]
                    brow = self._bw_rows[q.core]
                    for p in cores:
                        cand = qe + (lrow[p] + vol / brow[p])
                        if cand > ready[p]:
                            ready[p] = cand
                else:
                    placeable = False
                    break
            if not placeable:
                blocked_from = k
                break
            dur = self._wc_rows[sid]
            slot = sch.earliest_slot
            ends = [0.0] * C
            for p in cores:
                r = ready[p]
                if last_end[p] > r:
                    r = last_end[p]
                d = dur[p]
                ends[p] = slot(p, r, d) + d
            tentative_end[sid] = ends
            last_end = ends

        if blocked_from is None:
            return last_end                            # case 1
        # case 2: LU_p finish + pending execution times. The sums run
        # per core in the seed's order (LNU sum, then suffix sum, then
        # one add) so the 1e-12 scan sees identical floats.
        tp = [0.0] * C
        W = self._w_rows
        suffix = chain[blocked_from:]
        core_types = m.core_types
        for p in cores:
            lu = max(sch.core_available(p), last_end[p], rel)
            ptype = core_types[p]
            s_lnu = 0.0
            for s in self.lnu[p]:
                s_lnu += W[s][ptype]
            s_suf = 0.0
            for s in suffix:
                s_suf += W[s][ptype]
            tp[p] = lu + (s_lnu + s_suf)
        return tp

    # ---- step 3 (§3.4): matrix-backed cascade placement ----------------
    def _place(self, sid: int, queue) -> None:
        # same cascade as the seed, with comm times read off the
        # precomputed matrices instead of per-call level resolution
        g, sch = self.g, self.schedule
        off = self.off
        p = self.assigned_core[g.subtasks[sid].task_id]
        ready = self.release
        for pred, vol in g.preds[sid]:
            q = sch.placements[off + pred]
            c = q.core
            cand = q.end + (self._lat_rows[c][p] + vol / self._bw_rows[c][p])
            if cand > ready:
                ready = cand
        dur = self._wc_rows[sid][p]
        start = sch.earliest_slot(p, ready, dur)
        sch.place(off + sid, p, start, start + dur)
        self._on_placed(sid, queue)         # §3.5, inherited from the seed


def engine_schedule(graph: AppGraph, machine: MachineModel, *,
                    warm_start: Timeline | None = None,
                    release_time: float = 0.0,
                    sid_offset: int = 0) -> Timeline:
    """Array-engine counterpart of ``amtha_schedule`` — same placements,
    returns the (possibly warm-started) :class:`Timeline`."""
    return ArrayAMTHA(graph, machine, warm_start=warm_start,
                      release_time=release_time, sid_offset=sid_offset).run()
