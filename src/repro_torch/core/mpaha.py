"""MPAHA — Model of Parallel Algorithms on Heterogeneous Architectures.

The paper (De Giusti et al., 2010, §3) models a parallel application as a
directed graph G(V, E):

* V — tasks ``T_i``. Each task is an **ordered chain of subtasks**
  ``St_j``; the order is the order in which they must execute inside the
  task. Subtask compute cost is given *per processor type*
  (``V_i(s, p)`` in the paper).
* E — communication edges between a *source subtask* of one task and a
  *target subtask* of another, annotated with the **volume in bytes**
  (volume, not time: the graph stays architecture-independent; the
  machine model converts volume -> time).

This module is deliberately plain Python: the algorithm layer of the
paper is sequential/discrete; the batched simulator lowers its graphs
to arrays (``repro_torch.core.lowering``) for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Subtask:
    """One subtask. ``times[pt]`` = execution time on processor type pt."""

    sid: int
    task_id: int
    index_in_task: int              # position in the task's chain
    times: tuple[float, ...]        # indexed by processor-type id

    def time_on(self, ptype: int) -> float:
        return self.times[ptype]

    def w_avg_over(self, type_counts: list[int]) -> float:
        """Eq. (2): average over *processors* (weighted by type counts)."""
        total = sum(self.times[t] * c for t, c in enumerate(type_counts))
        return total / sum(type_counts)


@dataclass(frozen=True)
class CommEdge:
    """Directed communication: ``src`` subtask -> ``dst`` subtask, bytes."""

    src: int                        # subtask id
    dst: int                        # subtask id
    volume: float                   # bytes (graph is volume-annotated)


@dataclass
class AppGraph:
    """The MPAHA graph: tasks of chained subtasks + inter-task comm edges."""

    n_types: int
    subtasks: list[Subtask] = field(default_factory=list)
    tasks: dict[int, list[int]] = field(default_factory=dict)   # task -> [sid] in chain order
    edges: list[CommEdge] = field(default_factory=list)

    # ---- construction -------------------------------------------------
    def add_task(self, task_id: int, subtask_times: list[tuple[float, ...]]) -> list[int]:
        if task_id in self.tasks:
            raise ValueError(f"duplicate task {task_id}")
        sids = []
        for k, times in enumerate(subtask_times):
            if len(times) != self.n_types:
                raise ValueError("times must cover every processor type")
            sid = len(self.subtasks)
            self.subtasks.append(Subtask(sid, task_id, k, tuple(times)))
            sids.append(sid)
        self.tasks[task_id] = sids
        return sids

    def add_edge(self, src: int, dst: int, volume: float) -> None:
        if self.subtasks[src].task_id == self.subtasks[dst].task_id:
            raise ValueError("comm edges connect *different* tasks (chains are implicit)")
        self.edges.append(CommEdge(src, dst, float(volume)))

    # ---- derived structure (cached) -----------------------------------
    def finalize(self) -> None:
        """Build predecessor/successor maps. Chain edges are implicit:
        subtask k of a task depends on subtask k-1 of the same task.

        Idempotent: callers invoke it unconditionally; a repeat call with
        an unchanged graph is a no-op, and adding tasks/edges after a
        finalize simply rebuilds the maps."""
        fp = (len(self.subtasks), len(self.edges))
        if getattr(self, "_finalized", None) == fp:
            return
        n = len(self.subtasks)
        self.preds: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        self.succs: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for sids in self.tasks.values():
            for a, b in zip(sids, sids[1:]):
                self.preds[b].append((a, 0.0))     # intra-task: no comm volume
                self.succs[a].append((b, 0.0))
        for e in self.edges:
            self.preds[e.dst].append((e.src, e.volume))
            self.succs[e.src].append((e.dst, e.volume))
        self._check_acyclic()
        self._finalized = fp

    def _check_acyclic(self) -> None:
        n = len(self.subtasks)
        indeg = [len(self.preds[s]) for s in range(n)]
        stack = [s for s in range(n) if indeg[s] == 0]
        seen = 0
        while stack:
            s = stack.pop()
            seen += 1
            for t, _ in self.succs[s]:
                indeg[t] -= 1
                if indeg[t] == 0:
                    stack.append(t)
        if seen != n:
            raise ValueError("MPAHA graph has a cycle")

    # ---- queries used by AMTHA ----------------------------------------
    def w_avg(self, sid: int, type_counts: list[int]) -> float:
        return self.subtasks[sid].w_avg_over(type_counts)

    def task_t_avg(self, task_id: int, type_counts: list[int]) -> float:
        """Eq. (3): total average execution time of a task."""
        return sum(self.w_avg(s, type_counts) for s in self.tasks[task_id])

    @property
    def n_subtasks(self) -> int:
        return len(self.subtasks)

    def task_ids(self) -> list[int]:
        return sorted(self.tasks)


def merge_graphs(graphs: list[AppGraph]) -> tuple[AppGraph, list[int]]:
    """Disjoint union of independent applications into one MPAHA graph.

    Returns the merged graph plus, per input graph, the subtask-id offset
    its local sids were shifted by (task ids are shifted the same way the
    online subsystem shifts them: by the running task count). Used to
    validate and simulate a whole cluster timeline at once.
    """
    if not graphs:
        raise ValueError("merge_graphs needs at least one graph")
    n_types = graphs[0].n_types
    if any(g.n_types != n_types for g in graphs):
        raise ValueError("all graphs must share the processor-type space")
    merged = AppGraph(n_types=n_types)
    offsets: list[int] = []
    task_off = 0
    for g in graphs:
        off = len(merged.subtasks)
        offsets.append(off)
        for st in g.subtasks:               # sid order => merged sid = off + sid
            merged.subtasks.append(
                Subtask(off + st.sid, task_off + st.task_id,
                        st.index_in_task, st.times))
        for tid, sids in g.tasks.items():
            merged.tasks[task_off + tid] = [off + s for s in sids]
        for e in g.edges:
            merged.edges.append(CommEdge(off + e.src, off + e.dst, e.volume))
        task_off += max(g.tasks, default=-1) + 1
    merged.finalize()
    return merged, offsets
