"""Carry state across from the reference package, by attribute.

The port never imports the JAX package. These builders read the public
attributes that the reference's ``AppGraph``, ``MachineModel`` and
``Schedule`` / ``Timeline`` carry (this package's own types carry the
same ones), so a graph generated, a machine described or a schedule
mapped on either side can be simulated on the other. Fault scripts need
no conversion: :func:`~repro_torch.core.lowering.lower_faults` reads
them by attribute already.
"""

from __future__ import annotations

from typing import Any

from .machine import CommLevel, MachineModel
from .mpaha import AppGraph, CommEdge, Subtask
from .schedule import Schedule


def graph_from(obj: Any) -> AppGraph:
    """An :class:`AppGraph` with ``obj``'s subtasks (same sids, task ids,
    chain positions and per-type times), tasks and edges, in the same
    order — so the finalized adjacency, and every float derived from
    it, matches the source graph's."""
    g = AppGraph(n_types=int(obj.n_types))
    g.subtasks = [Subtask(int(st.sid), int(st.task_id),
                          int(st.index_in_task),
                          tuple(float(x) for x in st.times))
                  for st in obj.subtasks]
    g.tasks = {int(t): [int(s) for s in sids]
               for t, sids in obj.tasks.items()}
    g.edges = [CommEdge(int(e.src), int(e.dst), float(e.volume))
               for e in obj.edges]
    g.finalize()
    return g


def machine_from(obj: Any) -> MachineModel:
    """A :class:`MachineModel` with ``obj``'s cores, locations and
    communication levels."""
    return MachineModel(
        str(obj.name), [int(t) for t in obj.core_types],
        [tuple(int(x) for x in loc) for loc in obj.locations],
        [CommLevel(str(lv.name), float(lv.latency), float(lv.bandwidth))
         for lv in obj.levels],
        type_speeds=tuple(float(x) for x in obj.type_speeds),
        type_mem_bw=tuple(float(x) for x in obj.type_mem_bw))


def schedule_from(obj: Any) -> Schedule:
    """A :class:`Schedule` with ``obj``'s placements (a ``Schedule`` or a
    ``Timeline`` of either package): same cores, intervals and per-core
    order."""
    sch = Schedule(int(obj.n_cores))
    sch.extend_sorted((int(sid), int(p.core), float(p.start), float(p.end))
                      for sid, p in obj.placements.items())
    return sch
