"""Real (wall-clock) execution of a static schedule with threads.

The paper measures T_exec on real 8- and 64-core machines. Here the
schedule runs with **one thread per modelled core**: a subtask is a
calibrated sleep (model seconds scaled to wall seconds by
``time_scale``) and a communication is an event wait plus the remaining
transfer delay. Sleeping threads do not contend for the CPU, so the
wall-clock timeline reproduces OS-level concurrency, scheduling jitter
included: a *measured* T_exec, not a simulated one.

This is host code by nature: threads and the wall clock, no tensor and
no device. The T_exec it returns is wall-clock time, scaled back to
model seconds, so it varies from run to run and with the host's load;
hold it to invariants (it is never below the schedule's T_est, nor below
the jitter-free simulated makespan of the same scenario), never to an
exact value.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from .convert import graph_from, machine_from, schedule_from
from .machine import MachineModel
from .mpaha import AppGraph
from .schedule import Schedule


@dataclass
class ExecResult:
    t_exec: float                    # back in model units (seconds)
    wall_seconds: float

    def dif_rel(self, t_est: float) -> float:
        """The paper's %Dif_rel (Eq. 4): (T_exec - T_est) / T_exec * 100."""
        return (self.t_exec - t_est) / self.t_exec * 100.0


def execute_threaded(graph: AppGraph, machine: MachineModel,
                     schedule: Schedule, time_scale: float = 1e-3
                     ) -> ExecResult:
    """Run ``schedule`` of ``graph`` on ``machine`` with one thread per
    core. ``time_scale`` maps model seconds to wall seconds (5-50 s
    subtasks -> 5-50 ms sleeps). A graph, machine or schedule of the
    reference package (any object with its attributes) is converted
    first, so the caller's object is left as it was."""
    if not isinstance(graph, AppGraph):
        graph = graph_from(graph)
    if not isinstance(machine, MachineModel):
        machine = machine_from(machine)
    if not isinstance(schedule, Schedule):
        schedule = schedule_from(schedule)
    graph.finalize()

    done_evt = [threading.Event() for _ in range(graph.n_subtasks)]
    done_at = [0.0] * graph.n_subtasks
    t0 = time.perf_counter()
    time_scale = float(time_scale)

    def sleep_until(deadline: float) -> None:
        """Sleep with a short busy-wait tail: a plain ``time.sleep``
        overshoots by about 0.1-1 ms, which at ms-scale subtasks is a
        systematic +4-6 % bias on T_exec."""
        while True:
            delta = deadline - (time.perf_counter() - t0)
            if delta <= 0:
                return
            if delta > 2e-3:
                time.sleep(delta - 1e-3)
            elif delta > 2e-4:
                time.sleep(1e-4)
            # else spin

    def run_core(core: int) -> None:
        for sid in schedule.order_on_core(core):
            # wait for every predecessor, then for its data to arrive
            for pred, vol in graph.preds[sid]:
                done_evt[pred].wait()
                arrival = done_at[pred] + machine.comm_time(
                    vol, schedule.core_of(pred), core) * time_scale
                sleep_until(arrival)
            dur = graph.subtasks[sid].time_on(machine.core_types[core])
            sleep_until((time.perf_counter() - t0) + dur * time_scale)
            done_at[sid] = time.perf_counter() - t0
            done_evt[sid].set()

    threads = [threading.Thread(target=run_core, args=(c,), daemon=True)
               for c in range(machine.n_cores)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(done_at)
    return ExecResult(t_exec=wall / time_scale, wall_seconds=wall)
