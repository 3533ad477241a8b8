"""The GPipe pipeline over gloo ranks and AMTHA's stage plan, held
against the sequential port and the JAX package.

The reference test's case (``tests/test_pipeline.py``): reduced glm4-9b
in float32 cut to 4 layers, 4 pod ranks (one stage each), 3
microbatches of 2 x 16 tokens. The pipelined logits are within 2e-3 of
the per-microbatch ``forward`` of the port and of the reference, and the
gradients of mean(logits²) within 5e-3 of the port's autograd and of
``jax.grad`` of the reference's (the reference test's tolerances). Each
rank holds gradients for its own stage's layers only; the embedding,
final norm and head are whole on every rank, with equal gradients.
``plan_stages`` with explicit rates gives the reference's plan.

The spawn runs under a deadline that kills its ranks. JAX is imported
inside the tests, so the spawned ranks import torch alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.machine import H100_IB_BW, H100_PEAK_FLOPS
from repro_torch.launch.mesh import make_mesh, mesh_coords, spawn_cpu_ranks
from repro_torch.models import ShardCtx, forward, params_from_reference
from repro_torch.models.convert import reference_key
from repro_torch.runtime.pipeline import (make_pipelined_forward,
                                          plan_stages,
                                          predicted_pipeline_time,
                                          stage_layer_range)

DEADLINE = 120.0
FWD_TOL, GRAD_TOL = 2e-3, 5e-3       # tests/test_pipeline.py's
N_MICRO, BM, S, N_STAGES = 3, 2, 16, 4


def loss_of(logits):
    return logits.float().square().mean()


def pipeline_rank(rank, tree, cfg, tokens):
    """One pod rank: the pipelined logits, the gradient of every
    parameter (None where this rank's graph has none), its pod index;
    then the refusal of a stage count off the pod axis."""
    mesh = make_mesh((N_STAGES,), ("pod",), device_type="cpu")
    model = params_from_reference(tree, cfg)
    for p in model.parameters():
        p.requires_grad_(True)
    logits = make_pipelined_forward(cfg, mesh, N_STAGES)(
        model, torch.from_numpy(tokens))
    loss_of(logits).backward()
    grads = {k: None if p.grad is None else p.grad.numpy()
             for k, p in model.named_parameters()}
    try:
        make_pipelined_forward(cfg, mesh, 2)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return (mesh_coords(mesh)["pod"], logits.detach().numpy(), grads,
            refused)


def test_pipeline_matches_sequential_and_reference_and_differentiates():
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.models.model import forward as jax_forward
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from test_torch_models import reference_weights
    jax_cfg = jax_reduced(JAX_ARCHS["glm4-9b"]).replace(dtype="float32",
                                                        n_layers=4)
    cfg = reduced(ARCHS["glm4-9b"]).replace(dtype="float32", n_layers=4)
    tree = reference_weights(jax_cfg, seed=7)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab,
                                               (N_MICRO, BM, S))

    seq = params_from_reference(tree, cfg)
    for p in seq.parameters():
        p.requires_grad_(True)
    seq_logits = torch.stack([
        forward(seq, {"tokens": torch.from_numpy(tokens[i])}, cfg,
                ShardCtx(mode="train"))[0] for i in range(N_MICRO)])
    loss_of(seq_logits).backward()

    def jax_logits(params):
        return jnp.stack([jax_forward(params, {"tokens": jnp.asarray(t)},
                                      jax_cfg, JaxCtx(mode="train"))[0]
                          for t in tokens])
    params = jax.tree.map(jnp.asarray, tree)
    ref_logits = np.asarray(jax_logits(params))
    ref_grads = jax.grad(lambda p: jnp.square(
        jax_logits(p).astype(jnp.float32)).mean())(params)

    outs = spawn_cpu_ranks(N_STAGES, pipeline_rank, tree, cfg, tokens,
                           timeout=DEADLINE)
    assert sorted(o[0] for o in outs) == list(range(N_STAGES))
    for pod, logits, grads, refused in outs:
        assert refused == "2 stages on a pod axis of 4"
        for want in (seq_logits.detach().numpy(), ref_logits):
            assert np.abs(logits - want).max() < FWD_TOL
        mine = stage_layer_range(cfg, N_STAGES, pod)
        for name, g in grads.items():
            parts = name.split(".")
            if parts[0] == "layers" and int(parts[1]) not in mine:
                assert g is None, (pod, name)       # another stage's layer
                continue
            assert g is not None, (pod, name)
            path, rep = reference_key(name, cfg)
            want = np.asarray(_lookup(ref_grads, path))
            want = want[rep] if rep is not None else want
            seq_g = dict(seq.named_parameters())[name].grad.numpy()
            assert np.abs(g - seq_g).max() < GRAD_TOL, (pod, name)
            assert np.abs(g - want).max() < GRAD_TOL, (pod, name)


def _lookup(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.mark.parametrize("n_layers,n_pods,flops,act,speed,bw,lat", [
    (16, 2, 1e12, 1e8, None, None, 1e-5),
    (16, 2, 1e12, 1e8, 5e16, 6.4e9, 1e-5),
    (12, 4, 3e11, 2e7, 1e15, 4e10, 2e-6),
    (8, 1, 1e12, 1e8, 1e15, 1e10, 1e-5),
    (26, 13, 7e10, 4.7e6, 7.9e15, 5e10, 1e-5),
])
def test_plan_stages_equals_the_reference(n_layers, n_pods, flops, act,
                                          speed, bw, lat):
    """Given the same rates, the reference's plan: layers per stage,
    AMTHA's layer -> pod map, the hop and the tick. Without rates the
    port's defaults are one 8-GPU H100 node at the datasheet peak and
    one GPU's InfiniBand port (the reference's are TPU rates)."""
    from repro.runtime.pipeline import plan_stages as jax_plan_stages
    from repro.runtime.pipeline import predicted_pipeline_time as jax_pred
    if speed is None:
        per, sa = plan_stages(n_layers, n_pods, flops, act)
        hop = lat + act / H100_IB_BW
        assert sa.comm_time == hop
        assert sa.t_stage == per * flops / (8 * H100_PEAK_FLOPS) + hop
        return
    kw = dict(pod_speed_flops=speed, link_bandwidth=bw, link_latency=lat)
    per, sa = plan_stages(n_layers, n_pods, flops, act, **kw)
    want_per, want = jax_plan_stages(n_layers, n_pods, flops, act, **kw)
    assert per == want_per
    assert list(sa.layer_to_pod) == list(want.layer_to_pod)
    assert sa.comm_time == want.comm_time
    assert sa.t_stage == want.t_stage
    assert predicted_pipeline_time(sa.t_stage, n_pods, 4) == \
        jax_pred(want.t_stage, n_pods, 4)


def test_stage_ranges_and_refusals():
    gemma2 = ARCHS["gemma2-2b"]                     # 13 units of 2 layers
    assert list(stage_layer_range(gemma2, 13, 1)) == [2, 3]
    assert list(stage_layer_range(gemma2, 1, 0)) == list(range(26))
    with pytest.raises(ValueError, match="13 repeat units"):
        stage_layer_range(gemma2, 2, 0)
    with pytest.raises(ValueError, match="repeat-only"):
        make_pipelined_forward(ARCHS["deepseek-v2-lite-16b"], None, 1)
    with pytest.raises(ValueError, match="equal stages"):
        plan_stages(10, 4, 1e12, 1e8)
