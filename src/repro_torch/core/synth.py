"""Synthetic application generator — paper §5.1, parameter-for-parameter.

"A set of applications was selected, in which each of them varied in
terms of typical parameters: task size (5-50 seconds), number of
subtasks making up a task (3-6), communication volume among subtasks
(1000-10000), and communication probability between two different
subtasks (5-35%). Initially we worked with 15-25 tasks (with 8 cores)
and now we increased the number of tasks to 120-200, using 64 cores.
In all the applications, the total computing time exceeds that of
communications (coarse grained application)."

Interpretation notes (DESIGN.md §6):
* volumes are unitless in the paper; we use KB (``volume_unit=1024``)
  so comm stays visible but subordinate (coarse-grained regime);
* the communication probability is applied per ordered *task* pair with
  a topological ordering to keep the graph acyclic (one edge between
  random subtasks of the pair) — applying it per subtask pair would
  produce thousands of edges per app, contradicting coarse granularity;
* heterogeneity: optional processor types scale subtask times by a
  per-type speed factor plus per-subtask noise (the algorithm is
  heterogeneity-aware even though the paper's testbeds were homogeneous).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mpaha import AppGraph


@dataclass
class SynthParams:
    n_tasks: tuple[int, int] = (15, 25)            # 8-core regime; (120, 200) for 64
    subtasks_per_task: tuple[int, int] = (3, 6)
    task_size_s: tuple[float, float] = (5.0, 50.0)
    comm_volume: tuple[float, float] = (1000.0, 10000.0)
    comm_probability: tuple[float, float] = (0.05, 0.35)
    volume_unit: float = 1024.0                    # paper volumes -> bytes
    n_types: int = 1
    type_speed_factors: tuple[float, ...] = (1.0, 1.6, 0.75)
    hetero_noise: float = 0.05                     # per-subtask per-type jitter


def generate_app(params: SynthParams, seed: int) -> AppGraph:
    rng = np.random.default_rng(seed)
    n_tasks = int(rng.integers(params.n_tasks[0], params.n_tasks[1] + 1))
    comm_p = float(rng.uniform(*params.comm_probability))
    g = AppGraph(n_types=params.n_types)

    for t in range(n_tasks):
        n_st = int(rng.integers(params.subtasks_per_task[0],
                                params.subtasks_per_task[1] + 1))
        total = float(rng.uniform(*params.task_size_s))
        # split the task size across subtasks (Dirichlet keeps it exact)
        shares = rng.dirichlet(np.ones(n_st)) * total
        times = []
        for w in shares:
            per_type = []
            for ty in range(params.n_types):
                f = params.type_speed_factors[ty % len(params.type_speed_factors)]
                noise = float(rng.uniform(1 - params.hetero_noise,
                                          1 + params.hetero_noise)) \
                    if params.n_types > 1 else 1.0
                per_type.append(max(1e-3, w * f * noise))
            times.append(tuple(per_type))
        g.add_task(t, times)

    # topological task order -> acyclic comm edges
    order = rng.permutation(n_tasks)
    pos = {int(t): int(i) for i, t in enumerate(order)}
    for i in range(n_tasks):
        for j in range(n_tasks):
            if i == j or pos[i] >= pos[j]:
                continue
            if rng.uniform() < comm_p:
                src = int(rng.choice(g.tasks[i]))
                dst = int(rng.choice(g.tasks[j]))
                vol = float(rng.uniform(*params.comm_volume)) * params.volume_unit
                g.add_edge(src, dst, vol)

    g.finalize()
    return g


def paper_suite_8core(n_apps: int = 20, seed: int = 0,
                      n_types: int = 1) -> list[AppGraph]:
    p = SynthParams(n_tasks=(15, 25), n_types=n_types)
    return [generate_app(p, seed + i) for i in range(n_apps)]


def paper_suite_64core(n_apps: int = 10, seed: int = 100,
                       n_types: int = 1) -> list[AppGraph]:
    p = SynthParams(n_tasks=(120, 200), n_types=n_types)
    return [generate_app(p, seed + i) for i in range(n_apps)]
