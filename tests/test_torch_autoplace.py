"""repro_torch.autoplace against the reference's ``repro.autoplace``.

Mirrors ``tests/test_autoplace.py`` case for case, and holds the port to
the reference on the same inputs: the analytic unit costs bit for bit
for every arch; the pipeline and MoE graphs (subtask times, edge
volumes) on a machine ``core/convert.py`` builds from the reference's
``tpu_v5e_pod``; the ``engine``, ``amtha`` and ``ga`` placements. The
reference's ``source="hlo"`` is the port's ``source="counted"`` (the
unit's aten ops counted on fake tensors), held within the reference's
analytic-vs-HLO bounds. The executable round trip runs on 4 gloo ranks,
on a machine whose search returns a non-identity stage assignment.
"""

import numpy as np
import pytest
import torch

from repro import autoplace as ref_autoplace
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.machine import TPU_V5E_PEAK_FLOPS, tpu_v5e_pod
from repro_torch import autoplace
from repro_torch.analysis.entrypoints import _UNIT_FLOP_BOUNDS
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.convert import machine_from
from repro_torch.core.machine import H100_PEAK_FLOPS, MachineModel, h100_node
from repro_torch.core.registry import get_scheduler
from repro_torch.core.schedule import validate
from repro_torch.core.sim_engine import simulate_scenario
from repro_torch.launch.mesh import mesh_coords, spawn_cpu_ranks
from repro_torch.launch.op_analysis import analyze_call, fake_mode
from repro_torch.search.ga import GAParams

#: the host GA's fitness on the CPU (the default is the card's)
GA_CPU = {"params": GAParams(backend="numpy")}


def _ref_het():
    """The reference's heterogeneous machine: a half-speed second pod."""
    return tpu_v5e_pod(2, 4, type_speeds=(TPU_V5E_PEAK_FLOPS,
                                          TPU_V5E_PEAK_FLOPS / 2))


def _het_machine():
    """The port's: a second node of half-speed GPUs."""
    return h100_node(2, 4, type_speeds=(H100_PEAK_FLOPS,
                                        H100_PEAK_FLOPS / 2))


def _graphs_equal(port, ref):
    assert len(port.subtasks) == len(ref.subtasks)
    for a, b in zip(port.subtasks, ref.subtasks):
        assert (a.sid, a.task_id, a.index_in_task) == \
            (b.sid, b.task_id, b.index_in_task)
        assert tuple(a.times) == tuple(b.times)
    assert [(e.src, e.dst, e.volume) for e in port.edges] == \
        [(e.src, e.dst, e.volume) for e in ref.edges]


# ---------------------------------------------------------------------------
# cost terms and graphs, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,micro_batch", [(1024, 1), (128, 4)])
def test_analytic_unit_costs_equal_the_references_bit_for_bit(seq,
                                                              micro_batch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name in ARCHS:
        p = autoplace.unit_costs(ARCHS[name], seq=seq,
                                 micro_batch=micro_batch)
        r = ref_autoplace.unit_costs(REF_ARCHS[name], seq=seq,
                                     micro_batch=micro_batch)
        assert (p.n_units, p.layers_per_unit, p.flops, p.hbm_bytes,
                p.act_bytes, p.tokens, p.per_kind_flops) == \
            (r.n_units, r.layers_per_unit, r.flops, r.hbm_bytes,
             r.act_bytes, r.tokens, r.per_kind_flops), name
        assert autoplace.expert_flops_per_token(ARCHS[name]) == \
            ref_autoplace.expert_flops_per_token(REF_ARCHS[name])


def test_hlo_source_refused_with_the_counted_one_named():
    with pytest.raises(ValueError, match="counted"):
        autoplace.unit_costs(ARCHS["gemma-2b"], source="hlo")


def test_pipeline_graph_valid_for_every_arch():
    """Every config lowers to a finalized, schedulable AppGraph with
    positive costs on an H100 node, and the engine schedule survives the
    full validator AND the array lowering (simulated t_exec ==
    makespan); on the reference's machine, converted, the graph is the
    reference's, time for time and edge for edge."""
    machine = h100_node(1, 8)
    ref_machine = _ref_het()
    port_machine = machine_from(ref_machine)
    for name, cfg in sorted(ARCHS.items()):
        graph, costs = autoplace.model_pipeline_graph(cfg, machine,
                                                      seq=128, n_micro=3)
        assert costs.flops > 0 and costs.hbm_bytes > 0 \
            and costs.act_bytes > 0, name
        assert all(t > 0 for st in graph.subtasks for t in st.times), name
        assert all(e.volume > 0 for e in graph.edges), name
        for e in graph.edges:
            assert graph.subtasks[e.dst].task_id == \
                graph.subtasks[e.src].task_id + 1, name
        sched = get_scheduler("engine")(graph, machine).to_schedule()
        validate(sched, graph, machine)
        sim = simulate_scenario(graph, machine, sched, contention=False)
        np.testing.assert_allclose(sim.t_exec, sched.makespan(), rtol=1e-9)

        pg, _ = autoplace.model_pipeline_graph(cfg, port_machine, seq=128,
                                               n_micro=3)
        rg, _ = ref_autoplace.model_pipeline_graph(REF_ARCHS[name],
                                                   ref_machine, seq=128,
                                                   n_micro=3)
        _graphs_equal(pg, rg)


def test_stage_splits_balanced():
    assert autoplace.stage_splits(13, 8) == [2, 2, 2, 2, 2, 1, 1, 1]
    assert autoplace.stage_splits(12, 4) == [3, 3, 3, 3]
    assert autoplace.default_stages(13, 8) == 1      # no divisor <= 8
    assert autoplace.default_stages(13, 16) == 13
    assert autoplace.default_stages(48, 8) == 8


def test_moe_graph_fan_out_fan_in():
    cfg = ARCHS["qwen3-moe-235b-a22b"]
    machine = h100_node(1, 8)
    loads = [float(10 + i) for i in range(cfg.n_experts)]
    g = autoplace.moe_graph(cfg, machine, loads)
    assert len(g.tasks) == cfg.n_experts + 2
    disp, comb = g.tasks[0][0], g.tasks[cfg.n_experts + 1][0]
    outs = {e.dst for e in g.edges if e.src == disp}
    ins = {e.src for e in g.edges if e.dst == comb}
    experts = {g.tasks[1 + i][0] for i in range(cfg.n_experts)}
    assert outs == experts and ins == experts
    validate(get_scheduler("engine")(g, machine).to_schedule(), g, machine)
    ref_machine = tpu_v5e_pod(1, 8)
    _graphs_equal(autoplace.moe_graph(cfg, machine_from(ref_machine), loads),
                  ref_autoplace.moe_graph(REF_ARCHS[cfg.name], ref_machine,
                                          loads))


# ---------------------------------------------------------------------------
# FLOP bookkeeping against the counted source (the reference's hlo)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,lo,hi", [
    # global-attention archs agree tightly with the counted ops
    ("gemma-2b", 0.85, 1.15),
    # the windowed local layers: the closed form counts the window, the
    # plain attention every key — the reference's loose tolerance
    ("gemma2-2b", 0.60, 1.20),
])
def test_graph_flops_within_tolerance_of_counted(arch, lo, hi):
    assert _UNIT_FLOP_BOUNDS[arch] == (lo, hi)
    cfg = ARCHS[arch]
    machine = h100_node(1, 8)
    n_micro = 2
    graph, costs = autoplace.model_pipeline_graph(cfg, machine, seq=1024,
                                                  n_micro=n_micro)
    # bookkeeping identity: at seq 1024 the stages are compute-bound, so
    # inverting the roofline recovers exactly the analytic flops total
    graph_flops = autoplace.graph_total_flops(graph, machine) / n_micro
    np.testing.assert_allclose(graph_flops, costs.total_flops, rtol=1e-6)
    counted = autoplace.unit_costs(cfg, seq=1024, source="counted")
    assert counted.source == "counted" and counted.hbm_bytes > 0
    ratio = graph_flops / counted.total_flops
    assert lo < ratio < hi, f"{arch}: analytic/counted = {ratio:.3f}"


def test_counted_unit_flops_near_the_references_hlo_at_a_reduced_config():
    """Reduced mamba2-780m, one unit at 64 tokens: the counted FLOPs
    within 5 % of the reference's ``source="hlo"`` (1.028 on this
    config). An attention unit is not compared at toy dims: the
    reference's compiled attention works on padded blocks and counts
    4-8x the products its scores need, which the port's plain attention
    does not pad."""
    seq = 64
    port = autoplace.unit_costs(reduced(ARCHS["mamba2-780m"]), seq=seq,
                                source="counted")
    ref = ref_autoplace.unit_costs(ref_reduced(REF_ARCHS["mamba2-780m"]),
                                   seq=seq, source="hlo")
    assert 0.95 <= port.flops / ref.flops <= 1.05, port.flops / ref.flops


def test_op_analysis_counts_every_moe_repeat():
    """The eager counterpart of the reference's scan-vs-unrolled check:
    a MoE unit run 4 times counts exactly 4 times one run's dot FLOPs
    (no trip count to correct), the gating dot among them."""
    from repro_torch.autoplace.costs import unit_call
    from repro_torch.models.model import DTYPES
    cfg = reduced(ARCHS["qwen3-moe-235b-a22b"])
    n_rep, seq = 4, 32
    with fake_mode(), torch.no_grad():
        fn, layers = unit_call(cfg, ["moe_global"], torch.Generator(), "cpu")
        x = torch.zeros((1, seq, cfg.d_model), dtype=DTYPES[cfg.dtype])
        one = analyze_call(fn, layers, x)
        four = analyze_call(fn, layers * n_rep, x)
    assert one.dot_flops > 0
    assert four.dot_flops == n_rep * one.dot_flops
    # the dense path runs every expert on every token, and the router too
    expert_only = n_rep * seq * cfg.n_experts * \
        autoplace.expert_flops_per_token(cfg)
    assert four.dot_flops > expert_only


# ---------------------------------------------------------------------------
# placement: determinism, the best-of invariant, the reference's plans
# ---------------------------------------------------------------------------

def test_placement_deterministic_at_fixed_seed():
    for sched, kw in (("engine", None), ("ga", GA_CPU)):
        plans = [autoplace.place_pipeline(ARCHS["gemma-2b"], _het_machine(),
                                          scheduler=sched, seed=3,
                                          sched_kwargs=kw)
                 for _ in range(2)]
        assert plans[0].stage_to_device == plans[1].stage_to_device
        assert plans[0].makespans == plans[1].makespans


@pytest.mark.parametrize("sched", ["engine", "amtha", "ga"])
def test_pipeline_plans_are_the_references(sched):
    """On the reference's machines, converted, every plan field is the
    reference's: the stage vector, each candidate's makespan, the
    choice. The host GA draws the reference's NumPy stream from the same
    seed, so its plan is the reference's too."""
    kw = GA_CPU if sched == "ga" else None
    for arch in ("gemma-2b", "gemma2-2b"):
        for ref_machine in (tpu_v5e_pod(1, 8), _ref_het()):
            p = autoplace.place_pipeline(ARCHS[arch],
                                         machine_from(ref_machine),
                                         scheduler=sched, seed=3,
                                         sched_kwargs=kw)
            r = ref_autoplace.place_pipeline(REF_ARCHS[arch], ref_machine,
                                             scheduler=sched, seed=3)
            assert (p.n_stages, p.stage_to_device, p.makespans, p.chosen,
                    p.repaired, p.t_autoplaced, p.t_heuristic) == \
                (r.n_stages, r.stage_to_device, r.makespans, r.chosen,
                 r.repaired, r.t_autoplaced, r.t_heuristic), (arch, sched)


def test_autoplaced_never_worse_than_heuristic():
    for arch in ("gemma-2b", "gemma2-2b", "mamba2-780m"):
        n_units = autoplace.unit_costs(ARCHS[arch]).n_units
        for machine in (h100_node(1, 8), _het_machine()):
            for executable in (True, False):
                plan = autoplace.place_pipeline(
                    ARCHS[arch], machine, scheduler="engine",
                    n_stages=min(n_units, machine.n_cores),
                    executable=executable)
                assert plan.t_autoplaced <= plan.t_heuristic + 1e-12, \
                    (arch, machine.name, executable, plan.makespans)
                if executable:
                    s2d = plan.stage_to_device
                    assert len(set(s2d)) == len(s2d)   # injective
                    assert max(s2d) < machine.n_cores


def test_search_beats_contiguous_on_heterogeneous_machine():
    """On a half-speed second node, co-locating light stages on fast
    GPUs strictly beats contiguous-by-id."""
    plan = autoplace.place_pipeline(ARCHS["gemma2-2b"], _het_machine(),
                                    n_stages=8, executable=False)
    assert plan.t_autoplaced < plan.t_heuristic * 0.999, plan.makespans
    assert plan.machine.name.startswith("h100")


def test_expert_plan_permutation_and_invariant():
    cfg = ARCHS["qwen3-moe-235b-a22b"]
    loads = [float(1 + (7 * i) % 13) for i in range(cfg.n_experts)]
    ep = autoplace.place_moe_experts(cfg, loads, n_devices=8)
    e = cfg.n_experts
    assert sorted(ep.permutation) == list(range(e))
    assert sorted(ep.expert_to_device) == sorted(i % 8 for i in range(e))
    assert ep.t_autoplaced <= ep.t_roundrobin + 1e-12
    devs = [ep.expert_to_device[i] for i in ep.permutation]
    assert devs == sorted(devs)
    ep2 = autoplace.place_moe_experts(cfg, loads, n_devices=8)
    assert ep2.expert_to_device == ep.expert_to_device


@pytest.mark.parametrize("sched", ["engine", "amtha"])
def test_expert_plans_are_the_references(sched):
    cfg = ARCHS["qwen3-moe-235b-a22b"]
    loads = [float(1 + (7 * i) % 13) for i in range(cfg.n_experts)]
    ref_machine = tpu_v5e_pod(1, 8)
    p = autoplace.place_moe_experts(cfg, loads, machine_from(ref_machine),
                                    scheduler=sched)
    r = ref_autoplace.place_moe_experts(REF_ARCHS[cfg.name], loads,
                                        ref_machine, scheduler=sched)
    assert (p.expert_to_device, p.permutation, p.makespans) == \
        (r.expert_to_device, r.permutation, r.makespans)


def test_expert_permutation_preserves_logits():
    from repro_torch.models.model import ShardCtx, forward, init_params
    from repro_torch.sharding.partition import permute_expert_params

    cfg = reduced(ARCHS["qwen3-moe-235b-a22b"]).replace(dtype="float32")
    loads = [float(1 + i) for i in range(cfg.n_experts)]
    ep = autoplace.place_moe_experts(cfg, loads, n_devices=4)
    assert ep.permutation != list(range(cfg.n_experts))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    ctx = ShardCtx(mode="train")
    want = forward(model, {"tokens": tokens}, cfg, ctx)[0]
    got = forward(permute_expert_params(model, ep.permutation),
                  {"tokens": tokens}, cfg, ctx)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# executable round trip on 4 gloo ranks
# ---------------------------------------------------------------------------

def _interleaved_machine() -> MachineModel:
    """Two H100 nodes of 2 GPUs, the second at half speed, whose ranks
    alternate between the nodes (rank r on node r % 2): the contiguous
    assignment crosses InfiniBand at every hop, so the search moves the
    stages."""
    base = h100_node(2, 2, type_speeds=(H100_PEAK_FLOPS,
                                        H100_PEAK_FLOPS / 2))
    locations = [(r % 2, r // 2, 0) for r in range(4)]
    return MachineModel("h100 2x2, ranks across the nodes in turn",
                        [n for n, _, _ in locations], locations,
                        base.levels, type_speeds=base.type_speeds,
                        type_mem_bw=base.type_mem_bw)


def _pipeline_roundtrip(rank, cfg, stage_to_device, n_micro, bm, seq):
    from repro_torch import autoplace as ap
    from repro_torch.models.model import ShardCtx, forward, init_params
    from repro_torch.runtime.pipeline import make_pipelined_forward
    mesh = ap.stage_mesh(stage_to_device, device_type="cpu")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (n_micro, bm, seq)))
    fwd = make_pipelined_forward(cfg, mesh, n_stages=len(stage_to_device))
    with torch.no_grad():
        logits = fwd(model, tokens)
        want = torch.stack([forward(model, {"tokens": tokens[i]}, cfg,
                                    ShardCtx(mode="train"))[0]
                            for i in range(n_micro)])
    return (tuple(logits.shape), float((logits - want).abs().max()),
            mesh_coords(mesh)["pod"])


def test_stage_assignment_round_trips_into_pipelined_forward():
    """A searched placement that is not the identity, applied via
    ``stage_mesh``, gives the sequential forward's logits on every rank
    (gemma2's two-kind repeat unit, 4 units in 4 stages). The stage at
    coordinate s runs on rank ``stage_to_device[s]``, whose index in the
    pod group is not s: gpipe must take its neighbours from the mesh."""
    cfg = reduced(ARCHS["gemma2-2b"]).replace(dtype="float32", n_layers=8)
    n_micro, bm, seq = 3, 2, 16
    plan = autoplace.place_pipeline(cfg, _interleaved_machine(),
                                    scheduler="engine", n_micro=n_micro,
                                    seq=seq, micro_batch=bm)
    assert plan.n_stages == 4, plan.n_stages
    s2d = plan.stage_to_device
    assert sorted(s2d) == [0, 1, 2, 3] and s2d != [0, 1, 2, 3], plan.report()
    assert plan.t_autoplaced < plan.t_heuristic
    out = spawn_cpu_ranks(4, _pipeline_roundtrip, cfg, s2d, n_micro, bm,
                          seq, timeout=180)
    for rank, (shape, err, coord) in enumerate(out):
        assert shape == (n_micro, bm, seq, cfg.vocab)
        assert s2d[coord] == rank
        assert err < 2e-3, (rank, err)
