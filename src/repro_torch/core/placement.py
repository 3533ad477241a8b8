"""AMTHA as the placement engine of the training and serving stack,
mirrored from the JAX package's ``core/placement.py`` onto nodes of H100
GPUs.

Two production mapping problems are cast as MPAHA graphs and solved with
the unmodified AMTHA algorithm (the paper's §4 argument — the model does
not change with the architecture — carried up to GPU nodes):

1. **Expert placement (MoE/EP)** — experts of a layer are independent
   tasks whose subtask time is proportional to their routed load; the
   machine is the set of expert-parallel GPUs. AMTHA's
   processor-selection (min finish time) yields a load-balanced
   expert -> device map; ``permutation`` turns it into a weight
   permutation a sharded expert axis can apply. Compared against
   round-robin (:func:`round_robin_placement`).

2. **Layer -> node stage assignment** — transformer blocks are tasks
   chained by activation-volume edges; nodes ("pods" in the names kept
   from the reference) are processors joined by the slow inter-node
   level. AMTHA recovers contiguous splits on homogeneous nodes and
   shifts the cut under heterogeneous node speeds.

Every rate a function uses is a keyword (``peak_flops``, ``link_bw``)
whose default is the H100 datasheet figure of
:mod:`repro_torch.core.machine`; given the reference's rates, each
function returns what the reference's does. The expert-parallel
machine is one H100 node (``h100_node(1, n)``); its link rates do not
enter the placement, since a layer's experts share no edges.

T_est from the resulting schedule is the mapping layer's predicted step
time.
"""

from __future__ import annotations

from dataclasses import dataclass

from .machine import (H100_IB_BW, H100_PEAK_FLOPS, CommLevel, MachineModel,
                      h100_node)
from .mpaha import AppGraph
from .registry import get_scheduler
from .schedule import Schedule


# ---------------------------------------------------------------------------
# 1. Expert placement
# ---------------------------------------------------------------------------

@dataclass
class ExpertPlacement:
    expert_to_device: list[int]      # device index per expert
    permutation: list[int]           # experts reordered so contiguous groups
    t_est: float                     # predicted makespan (s)

    def device_loads(self, loads: list[float], n_devices: int) -> list[float]:
        out = [0.0] * n_devices
        for e, d in enumerate(self.expert_to_device):
            out[d] += loads[e]
        return out


def expert_graph(loads_flops: list[float],
                 peak_flops: float = H100_PEAK_FLOPS) -> AppGraph:
    """Each expert = one task, one subtask, time = load/peak. No edges —
    experts of a layer are independent; AMTHA degenerates to its
    processor-selection rule, i.e. min-finish-time load balancing."""
    g = AppGraph(n_types=1)
    for e, load in enumerate(loads_flops):
        g.add_task(e, [(max(load, 1.0) / peak_flops,)])
    g.finalize()
    return g


def ep_machine(n_devices: int,
               peak_flops: float = H100_PEAK_FLOPS) -> MachineModel:
    """``n_devices`` expert-parallel GPUs of one node, each of
    ``peak_flops``: ``h100_node(1, n_devices)``."""
    return h100_node(1, n_devices, type_speeds=(peak_flops,))


def place_experts(loads_flops: list[float], n_devices: int,
                  experts_per_device: int | None = None,
                  scheduler: str = "engine",
                  peak_flops: float = H100_PEAK_FLOPS) -> ExpertPlacement:
    """AMTHA placement of experts onto EP devices (:func:`ep_machine`).
    If ``experts_per_device`` is given (sharding needs equal groups), the
    assignment is balanced greedily from AMTHA's ordering to exactly
    that group size — the permutation is then directly usable as a
    weight reorder for an evenly-sharded expert axis. ``scheduler``
    picks the mapper from the registry (the array engine by default)."""
    n_exp = len(loads_flops)
    if experts_per_device is None:
        experts_per_device = n_exp // n_devices
    if experts_per_device * n_devices != n_exp:
        raise ValueError(f"{n_exp} experts do not tile {n_devices} devices "
                         f"of {experts_per_device}")
    machine = ep_machine(n_devices, peak_flops)
    graph = expert_graph(loads_flops, machine.type_speeds[0])
    sched = get_scheduler(scheduler)(graph, machine)

    # AMTHA order of assignment, capacity-constrained to equal groups:
    # walk experts by decreasing load (AMTHA's rank order for independent
    # tasks) and send each to the least-loaded device with space.
    order = sorted(range(n_exp), key=lambda e: -loads_flops[e])
    dev_load = [0.0] * n_devices
    dev_count = [0] * n_devices
    assign = [-1] * n_exp
    for e in order:
        cands = [d for d in range(n_devices)
                 if dev_count[d] < experts_per_device]
        d = min(cands, key=lambda d: dev_load[d])
        assign[e] = d
        dev_load[d] += loads_flops[e]
        dev_count[d] += 1

    # contiguous permutation: experts grouped by device
    perm = sorted(range(n_exp), key=lambda e: (assign[e], e))
    # predicted step time: the capacity-constrained makespan; AMTHA's own
    # uncapacitated schedule (``sched``) lower-bounds it.
    t_est = max(max(dev_load) / machine.type_speeds[0], sched.makespan())
    return ExpertPlacement(assign, perm, t_est)


def round_robin_placement(loads_flops: list[float], n_devices: int,
                          peak_flops: float = H100_PEAK_FLOPS
                          ) -> ExpertPlacement:
    """Expert e on device e mod ``n_devices``: the baseline."""
    n_exp = len(loads_flops)
    assign = [e % n_devices for e in range(n_exp)]
    perm = sorted(range(n_exp), key=lambda e: (assign[e], e))
    dev = [0.0] * n_devices
    for e, d in enumerate(assign):
        dev[d] += loads_flops[e]
    return ExpertPlacement(assign, perm, max(dev) / peak_flops)


# ---------------------------------------------------------------------------
# 2. Layer -> node stage assignment
# ---------------------------------------------------------------------------

@dataclass
class StageAssignment:
    layer_to_pod: list[int]
    t_est: float
    schedule: Schedule
    # the comm-aware per-microbatch stage tick time and its communication
    # component, for a pipeline planner to fill (0.0 when the caller did
    # not model the link)
    t_stage: float = 0.0
    comm_time: float = 0.0


def layer_graph(layer_flops: list[float], activation_bytes: list[float],
                pod_speed_flops: list[float]) -> AppGraph:
    """Tasks = layer blocks (1 subtask each, per-node-type times); chain
    edges carry activation volume. ``pod_speed_flops[t]`` is aggregate
    node compute for type t."""
    if len(activation_bytes) not in (len(layer_flops) - 1, len(layer_flops)):
        raise ValueError(f"{len(activation_bytes)} activation volumes for "
                         f"{len(layer_flops)} layers")
    n_types = len(pod_speed_flops)
    g = AppGraph(n_types=n_types)
    sids = []
    for i, fl in enumerate(layer_flops):
        s = g.add_task(i, [tuple(fl / sp for sp in pod_speed_flops)])
        sids.append(s[0])
    for i in range(len(layer_flops) - 1):
        g.add_edge(sids[i], sids[i + 1], activation_bytes[i])
    g.finalize()
    return g


def pod_machine(pod_types: list[int], n_types: int,
                link_bw: float = H100_IB_BW) -> MachineModel:
    """One processor per node (``pod_types[p]`` its type), joined by the
    inter-node level at ``link_bw``."""
    locations = [(p,) for p in range(len(pod_types))]
    levels = [CommLevel("infiniband", 1e-5, link_bw)]
    m = MachineModel("pods", pod_types, locations, levels)
    m.n_types = n_types
    return m


def assign_layers_to_pods(layer_flops: list[float],
                          activation_bytes: list[float],
                          pod_speed_flops: list[float],
                          pod_types: list[int] | None = None,
                          scheduler: str = "engine",
                          link_bw: float = H100_IB_BW) -> StageAssignment:
    """Map layer blocks to nodes with AMTHA; the inter-node level
    penalizes every cross-node activation edge, so AMTHA naturally
    produces (near-) contiguous stages and shifts the boundary toward
    faster nodes."""
    n_types = len(pod_speed_flops)
    if pod_types is None:
        pod_types = list(range(n_types))
    g = layer_graph(layer_flops, activation_bytes, pod_speed_flops)
    m = pod_machine(pod_types, n_types, link_bw)
    sched = get_scheduler(scheduler)(g, m)
    layer_to_pod = [sched.core_of(g.tasks[i][0])
                    for i in range(len(layer_flops))]
    return StageAssignment(layer_to_pod, sched.makespan(), sched)
