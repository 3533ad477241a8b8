"""Mapping vectors: the search representation of a task-coherent schedule.

A candidate mapping is one int vector ``assign`` of length ``n_tasks``
(positional over ``list(graph.tasks)``), ``assign[k]`` = core of task
``k`` — exactly the chromosome of the bias-elitist GA literature (Quan &
Pimentel 2014). Every vector decodes to a *valid* schedule: the decoder
walks subtasks in one fixed topological order and places each on its
task's core at the earliest gap after its predecessors' data has
arrived, so precedence, non-overlap and task coherence hold by
construction for any gene values. That makes the search space the full
``C^n_tasks`` grid with no repair step.

``encode`` inverts any task-coherent schedule into a vector — the elite
seeding bridge from the AMTHA/engine heuristic into the population.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..core import lowering
from ..core.machine import MachineModel
from ..core.mpaha import AppGraph
from ..core.timeline import Timeline


def task_ids(graph: AppGraph) -> list[int]:
    """Gene position -> task id (insertion order of ``graph.tasks``)."""
    return list(graph.tasks)


def topo_order(graph: AppGraph) -> list[int]:
    """Deterministic sid-ordered Kahn walk over deps ∪ chain edges,
    cached on the graph: the decoder's fixed placement order."""
    graph.finalize()
    fp = (len(graph.subtasks), len(graph.edges))
    cached = getattr(graph, "_search_topo", None)
    if cached is not None and cached[0] == fp:
        return cached[1]
    n = graph.n_subtasks
    indeg = [len(graph.preds[s]) for s in range(n)]
    heap = [s for s in range(n) if indeg[s] == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        s = heapq.heappop(heap)
        order.append(s)
        for t, _ in graph.succs[s]:
            indeg[t] -= 1
            if indeg[t] == 0:
                heapq.heappush(heap, t)
    assert len(order) == n, "graph has a cycle"
    graph._search_topo = (fp, order)
    return order


def _decode_views(graph: AppGraph, machine: MachineModel):
    """(lat rows, bw rows, exec rows) as plain-float lists, cached on the
    frozen GraphArrays keyed by the machine's MachineArrays — a GA
    population decodes B candidates of the same (graph, machine), so the
    O(S·C) gather + tolist conversions are paid once, not per candidate."""
    ma = lowering.machine_arrays(machine)
    ga = lowering.graph_arrays(graph)
    cached = ga.__dict__.get("_decode_views")
    if cached is None or cached[0] is not ma:
        cached = (ma, ma.lat.tolist(), ma.bw.tolist(),
                  ga.exec_type[:, ma.core_types].tolist())
        object.__setattr__(ga, "_decode_views", cached)
    return cached[1], cached[2], cached[3]


def encode(graph: AppGraph, schedule, strict: bool = True) -> np.ndarray:
    """Task-coherent schedule -> ``(n_tasks,)`` core vector.

    ``strict=False`` tolerates split tasks (a recovered timeline where a
    partially-executed task was re-mapped): the gene is the core holding
    the most of the task's subtasks (ties to the lowest core id) — the
    lossy-but-usable elite seed for mid-flight refinement."""
    out = np.empty(len(graph.tasks), np.int32)
    for k, t in enumerate(task_ids(graph)):
        cores = [schedule.placements[s].core for s in graph.tasks[t]]
        uniq = set(cores)
        if len(uniq) > 1:
            if strict:
                raise ValueError(f"task {t} split across cores {uniq}; "
                                 "only task-coherent schedules encode")
            out[k] = max(sorted(uniq), key=cores.count)
        else:
            out[k] = uniq.pop()
    return out


def decode(graph: AppGraph, machine: MachineModel, assign,
           *, releases: dict[int, float] | None = None,
           frozen: dict | None = None, gap_fill: bool = True) -> Timeline:
    """Core vector -> schedule, via topological list placement.

    Each subtask starts at the earliest free gap on its task's core at
    or after ``max(release floor, pred end + lat + vol/bw over every
    predecessor)`` — the same readiness expression the validator and
    the analytic simulator use (same-core matrix entries are ``(0,
    inf)`` so co-located edges contribute an exact ``0.0``).

    ``frozen`` — ``sid -> Placement`` of immutable history (work already
    started or finished when a mid-flight refinement runs): those
    intervals are pre-placed verbatim, genes only steer the remaining
    subtasks, and frozen predecessors feed readiness like any other.
    With frozen subtasks present the result is generally *not*
    task-coherent (validate with ``require_task_coherence=False``).

    ``gap_fill=False`` switches to append-only placement: each subtask
    starts at ``max(ready, core frontier)`` with no backfilling into
    earlier gaps — the semantics of the reference's device-resident
    decoder, kept here as its host oracle."""
    assign = np.asarray(assign, np.int32)
    tids = task_ids(graph)
    if len(assign) != len(tids):
        raise ValueError(f"{len(assign)} genes for {len(tids)} tasks")
    if len(assign) and not (0 <= assign.min() and
                            assign.max() < machine.n_cores):
        raise ValueError("core index out of range")
    core_of_task = {t: int(c) for t, c in zip(tids, assign)}

    lat_rows, bw_rows, exec_rows = _decode_views(graph, machine)
    subtasks = graph.subtasks

    sch = Timeline(machine.n_cores)
    if frozen:
        sch.extend_sorted((sid, p.core, p.start, p.end)
                          for sid, p in frozen.items())
    frontier = None
    if not gap_fill:
        frontier = [0.0] * machine.n_cores
        if frozen:
            for p in frozen.values():
                if p.end > frontier[p.core]:
                    frontier[p.core] = p.end
    placements = sch.placements
    for sid in topo_order(graph):
        if frozen and sid in placements:
            continue
        core = core_of_task[subtasks[sid].task_id]
        ready = releases.get(sid, 0.0) if releases else 0.0
        for pred, vol in graph.preds[sid]:
            q = placements[pred]
            cand = q.end + (lat_rows[q.core][core]
                            + vol / bw_rows[q.core][core])
            if cand > ready:
                ready = cand
        dur = exec_rows[sid][core]
        if gap_fill:
            start = sch.earliest_slot(core, ready, dur)
        else:
            start = max(ready, frontier[core])
            frontier[core] = start + dur
        sch.place(sid, core, start, start + dur)
    return sch


def decode_population(graph: AppGraph, machine: MachineModel, population,
                      *, releases: dict[int, float] | None = None,
                      frozen: dict | None = None,
                      gap_fill: bool = True) -> list[Timeline]:
    return [decode(graph, machine, a, releases=releases, frozen=frozen,
                   gap_fill=gap_fill)
            for a in population]
