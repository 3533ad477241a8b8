"""The port's placement layer (``repro_torch.core.placement``) and its
H100 machine model, held against the JAX package's ``core/placement.py``.

The reference's own ``tests/test_placement.py`` cases, on the port (its
TPU pod machine becoming ``h100_node``); then, on loads drawn from
``np.random.default_rng(seed)``, ``place_experts`` and
``round_robin_placement`` equal to the reference's at four (experts,
devices) sizes when given the reference's peak, ``assign_layers_to_pods``
equal on homogeneous and heterogeneous nodes when given the reference's
inter-pod rate, and the H100 defaults giving valid schedules.
"""

import numpy as np
import pytest

from repro.core import placement as ref
from repro.core.machine import TPU_V5E_DCI_BW, TPU_V5E_PEAK_FLOPS
from repro_torch.core import (assign_layers_to_pods, dell_poweredge_1950,
                              get_scheduler, h100_node, hp_bl260c,
                              place_experts, round_robin_placement, validate)
from repro_torch.core import placement
from repro_torch.core.machine import (H100_HBM_BW, H100_IB_BW,
                                      H100_NVLINK_BW, H100_PEAK_FLOPS)


# ---------------------------------------------------------------------------
# the reference's placement tests, on the port
# ---------------------------------------------------------------------------

def test_machine_hierarchy_levels():
    m = dell_poweredge_1950()
    assert m.n_cores == 8
    # same pair -> L2 (fastest); same socket -> ram-local; cross -> slowest
    assert m.comm_level(0, 1).name == "l2-pair"
    assert m.comm_level(0, 2).name == "ram-local"
    assert m.comm_level(0, 4).name == "ram-socket"
    assert m.comm_time(1e6, 0, 1) < m.comm_time(1e6, 0, 2) < \
        m.comm_time(1e6, 0, 4)


def test_bl260c_network_is_slowest():
    m = hp_bl260c()
    assert m.n_cores == 64
    assert m.comm_level(0, 8).name == "gigabit-eth"      # cross blade
    assert m.comm_time(1e6, 0, 8) > m.comm_time(1e6, 0, 1) * 10


def test_h100_node_machine():
    """Levels slowest first (InfiniBand, NVLink, HBM) carrying the
    datasheet rates, locations (node, gpu, 0), the peaks attached."""
    m = h100_node(n_nodes=2, gpus_per_node=4)
    assert m.n_cores == 8 and m.name == "h100 2x4"
    assert [lv.name for lv in m.levels] == ["infiniband", "nvlink", "hbm"]
    assert [lv.bandwidth for lv in m.levels] == [H100_IB_BW, H100_NVLINK_BW,
                                                 H100_HBM_BW]
    assert m.levels[0].latency > m.levels[1].latency > m.levels[2].latency
    assert m.locations == [(n, g, 0) for n in range(2) for g in range(4)]
    assert m.comm_level(0, 1).name == "nvlink"
    assert m.comm_level(0, 4).name == "infiniband"
    assert m.comm_time(1e9, 0, 4) > m.comm_time(1e9, 0, 1)
    assert m.type_speeds == (H100_PEAK_FLOPS,) == (989e12,)
    assert m.type_mem_bw == (H100_HBM_BW,) == (3.35e12,)
    assert (H100_NVLINK_BW, H100_IB_BW) == (450e9, 50e9)
    hetero = h100_node(n_nodes=2, gpus_per_node=2,
                       type_speeds=(H100_PEAK_FLOPS, H100_PEAK_FLOPS / 2))
    assert hetero.core_types == [0, 0, 1, 1] and hetero.n_types == 2
    assert hetero.type_mem_bw == (H100_HBM_BW,) * 2


def test_expert_placement_equal_groups_and_balance():
    rng = np.random.default_rng(3)
    loads = list(rng.lognormal(0, 1, 32) * 1e9)
    pl = place_experts(loads, 4)
    counts = [pl.expert_to_device.count(d) for d in range(4)]
    assert counts == [8, 8, 8, 8]
    dev = pl.device_loads(loads, 4)
    # balanced within 2x of the ideal quarter
    assert max(dev) < 2 * sum(loads) / 4
    assert pl.t_est > 0


def test_layer_to_pod_prefers_faster_pod():
    flops = [1e12] * 8
    acts = [1e8] * 7
    fast = H100_PEAK_FLOPS * 8
    same = assign_layers_to_pods(flops, acts, [fast, fast])
    # a single chain has no pipelining benefit: one node hosts everything
    assert len(set(same.layer_to_pod)) == 1
    hetero = assign_layers_to_pods(flops, acts, [fast, 4 * fast])
    assert set(hetero.layer_to_pod) == {1}       # all on the 4x node
    assert hetero.t_est < same.t_est


def test_layer_graph_validates():
    with pytest.raises(ValueError):
        placement.layer_graph([1e12] * 3, [1.0] * 5, [1e12])
    with pytest.raises(ValueError):
        place_experts([1.0] * 10, 4)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def expert_loads(n_exp, seed):
    """Routed FLOPs per expert: skewed, some experts nearly idle."""
    rng = np.random.default_rng(seed)
    return list(rng.lognormal(0, 1.2, n_exp) * 1e9)


@pytest.mark.parametrize("how", ["place_experts", "round_robin_placement"])
@pytest.mark.parametrize("n_exp,n_dev", [(8, 2), (64, 8), (128, 8),
                                         (128, 16)])
def test_expert_placement_matches_reference(n_exp, n_dev, how):
    loads = expert_loads(n_exp, seed=n_exp + n_dev)
    want = getattr(ref, how)(loads, n_dev)
    got = getattr(placement, how)(loads, n_dev,
                                  peak_flops=TPU_V5E_PEAK_FLOPS)
    assert got.expert_to_device == want.expert_to_device
    assert got.permutation == want.permutation
    assert sorted(got.permutation) == list(range(n_exp))
    assert [got.expert_to_device.count(d) for d in range(n_dev)] == \
        [n_exp // n_dev] * n_dev
    np.testing.assert_allclose(got.t_est, want.t_est, rtol=1e-12)
    assert got.device_loads(loads, n_dev) == want.device_loads(loads, n_dev)


POD_CASES = {      # layer count, node speeds (x the reference's peak), types
    "homogeneous-2": (12, (64, 64), None),
    "heterogeneous-2": (12, (64, 256), None),
    "homogeneous-4": (24, (64,), [0, 0, 0, 0]),
    "heterogeneous-3-of-2-types": (16, (32, 96), [0, 1, 0]),
}


@pytest.mark.parametrize("case", list(POD_CASES))
def test_assign_layers_to_pods_matches_reference(case):
    n, speeds, types = POD_CASES[case]
    rng = np.random.default_rng(len(case))
    flops = list(rng.uniform(0.5, 2.0, n) * 1e12)
    acts = list(rng.uniform(0.5, 2.0, n - 1) * 1e8)
    speeds = [s * TPU_V5E_PEAK_FLOPS for s in speeds]
    want = ref.assign_layers_to_pods(flops, acts, speeds, types)
    got = assign_layers_to_pods(flops, acts, speeds, types,
                                link_bw=TPU_V5E_DCI_BW)
    assert got.layer_to_pod == want.layer_to_pod
    assert got.t_est == want.t_est
    assert got.schedule.makespan() == want.schedule.makespan()


def test_h100_defaults_give_valid_schedules():
    """AMTHA's schedule of a layer chain on two H100 nodes (one of half
    the speed) and of 64 experts' loads on one node of 8 GPUs, each
    proven by ``validate``; the capacity-bound placement on that node
    (``ep_machine(8)``, which is ``h100_node(1, 8)``) tiles it."""
    flops = list(np.random.default_rng(5).uniform(0.5, 2.0, 27) * 1e13)
    acts = [2 * 2048 * 2048 * 2.0] * 26            # B S d bf16 activations
    speeds = [8 * H100_PEAK_FLOPS, 4 * H100_PEAK_FLOPS]
    st = assign_layers_to_pods(flops, acts, speeds)
    validate(st.schedule, placement.layer_graph(flops, acts, speeds),
             placement.pod_machine([0, 1], 2))
    assert st.t_est >= sum(flops) / sum(speeds)

    loads = expert_loads(64, seed=9)
    node = h100_node(1, 8)
    ep = placement.ep_machine(8)
    assert (ep.locations, ep.levels, ep.type_speeds) == \
        (node.locations, node.levels, node.type_speeds)
    graph = placement.expert_graph(loads)
    validate(get_scheduler("engine")(graph, node), graph, node)
    pl = place_experts(loads, 8)
    rr = round_robin_placement(loads, 8)
    assert [pl.expert_to_device.count(d) for d in range(8)] == [8] * 8
    assert sorted(pl.permutation) == list(range(64))
    assert pl.t_est >= max(loads) / H100_PEAK_FLOPS
    assert rr.t_est == max(rr.device_loads(loads, 8)) / H100_PEAK_FLOPS
