"""The port's MoE FFN and MLA attention on the CPU, held against the JAX
package.

``router_topk``, ``expert_ffn`` and ``moe_dense`` against
``repro.models.moe`` on the same NumPy-made inputs: float32 within rtol
1e-5 (the ids exactly), ``moe_dense`` in bfloat16 within 2e-2 of the
largest output (both round each expert product to bfloat16 once, in
their own summation order, and combine in float32). Then the model-level
pieces the MoE/MLA slice adds: ``params_from_reference`` carrying a
MoE/MLA tree leaf for leaf, ``init_params``' MoE layout and scales, the
MLA prefill cache and its padding against the reference's, and the
decode insert refusing a position past the cache. The whole reduced
models run against the reference in ``test_torch_models.py`` and the
batcher in ``test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro.models.model import ShardCtx as JaxCtx
from repro.models.model import forward as jax_forward
from repro.runtime.serve_loop import pad_cache_to as jax_pad_cache_to
from repro_torch.models import (ShardCtx, block_plan, forward, init_cache,
                                init_params)
from repro_torch.models import moe
from repro_torch.runtime import pad_cache_to

from test_torch_models import (as_np, both_models, model_configs,
                               reference_weights, tensor)

F32_RTOL = 1e-5
BF16_REL = 2e-2


def moe_inputs(seed, t, d, e, f, dtype=np.float32):
    """x (T, D) N(0, 1); router (D, E) float32, wi (E, D, 2, F), wo (E,
    F, D) N(0, 1)/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d))
    router = rng.standard_normal((d, e)) / np.sqrt(d)
    wi = rng.standard_normal((e, d, 2, f)) / np.sqrt(d)
    wo = rng.standard_normal((e, f, d)) / np.sqrt(f)
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bfloat16" else (lambda a: a.astype(np.float32))
    return cast(x), router.astype(np.float32), cast(wi), cast(wo)


@pytest.mark.parametrize("t,d,e,k", [(7, 16, 8, 2), (64, 32, 64, 6),
                                     (33, 24, 128, 8), (5, 8, 4, 4)])
def test_router_topk_matches_reference(t, d, e, k):
    x, router, _, _ = moe_inputs(t + e, t, d, e, 4)
    w_want, ids_want, aux_want = jax_moe.router_topk(
        jnp.asarray(x), jnp.asarray(router), k)
    w_got, ids_got, aux_got = moe.router_topk(tensor(x), tensor(router), k)
    assert w_got.dtype == torch.float32 and ids_got.shape == (t, k)
    np.testing.assert_array_equal(ids_got.numpy(), np.asarray(ids_want))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_want),
                               rtol=F32_RTOL, atol=0)
    np.testing.assert_allclose(w_got.sum(-1).numpy(), 1.0, rtol=F32_RTOL)
    np.testing.assert_allclose(float(aux_got), float(aux_want),
                               rtol=F32_RTOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_expert_ffn_matches_reference(activation):
    rng = np.random.default_rng(1)
    xe = rng.standard_normal((4, 9, 16)).astype(np.float32)
    _, _, wi, wo = moe_inputs(2, 1, 16, 4, 24)
    want = jax_moe.expert_ffn(jnp.asarray(xe), jnp.asarray(wi),
                              jnp.asarray(wo), activation)
    got = moe.expert_ffn(tensor(xe), tensor(wi), tensor(wo), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_RTOL, atol=F32_RTOL)


@pytest.mark.parametrize("shape,e,k,activation", [
    ((2, 11, 32), 8, 2, "swiglu"), ((40, 16), 64, 6, "swiglu"),
    ((1, 3, 24), 16, 8, "geglu")])
def test_moe_dense_matches_reference_in_float32(shape, e, k, activation):
    """x (..., D) through every expert and the masked combine, within
    rtol 1e-5 (atol 1e-5 of the largest output, for sums near zero);
    the aux loss within rtol 1e-5."""
    t, d = int(np.prod(shape[:-1])), shape[-1]
    x, router, wi, wo = moe_inputs(sum(shape) + e, t, d, e, 20)
    x = x.reshape(shape)
    want, aux_want = jax_moe.moe_dense(
        jnp.asarray(x), dict(router=jnp.asarray(router), wi=jnp.asarray(wi),
                             wo=jnp.asarray(wo)), k, activation)
    got, aux = moe.moe_dense(tensor(x), tensor(router), tensor(wi),
                             tensor(wo), k, activation)
    assert got.shape == shape and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=F32_RTOL)


def test_moe_dense_matches_reference_in_bf16():
    """bfloat16 activations and experts, float32 router: the same
    routes, the output in bfloat16 within 2e-2 of the largest."""
    x, router, wi, wo = moe_inputs(5, 48, 32, 16, 24, dtype="bfloat16")
    want, aux_want = jax_moe.moe_dense(
        jnp.asarray(x), dict(router=jnp.asarray(router), wi=jnp.asarray(wi),
                             wo=jnp.asarray(wo)), 4, "swiglu")
    got, aux = moe.moe_dense(tensor(x), tensor(router), tensor(wi),
                             tensor(wo), 4, "swiglu")
    assert got.dtype == torch.bfloat16
    _, ids_want, _ = jax_moe.router_topk(jnp.asarray(x), jnp.asarray(router),
                                         4)
    _, ids_got, _ = moe.router_topk(tensor(x), tensor(router), 4)
    np.testing.assert_array_equal(ids_got.numpy(), np.asarray(ids_want))
    want = as_np(want)
    assert np.abs(as_np(got) - want).max() <= BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=F32_RTOL)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_carries_moe_and_mla_trees(name, dtype):
    """Every leaf of the reference's tree lands, bit for bit and in its
    own type (the router float32 in a bfloat16 model), on the port's
    module of the same layer; MoE layers hold ``moe`` and
    ``shared_mlp`` and no ``mlp``."""
    jax_cfg, cfg = model_configs(name, dtype)
    tree = reference_weights(jax_cfg, 3)
    params = both_models(name, seed=3, dtype=dtype)[3]
    prologue, n_rep, unit, _ = cfg.repeat_structure()
    refs = list(tree["prologue"]) + [
        {k: jax.tree.map(lambda a: a[r], v)
         for k, v in tree["groups"][str(pos)].items()}
        for r in range(n_rep) for pos in range(len(unit))]
    assert len(refs) == len(params.layers) == cfg.n_layers
    n = 0
    for kind, layer, ref in zip(cfg.layer_kinds(), params.layers, refs):
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        for path, leaf in flat:
            keys = [k.key for k in path]
            mod = layer
            for k in keys[:-1]:
                mod = getattr(mod, k)
            got = getattr(mod, keys[-1])
            want = tensor(leaf)
            assert got.dtype == want.dtype and torch.equal(got, want), keys
            n += 1
        assert hasattr(layer, "moe") == kind.startswith("moe")
        assert hasattr(layer, "mlp") != kind.startswith("moe")
        if kind.startswith("moe"):
            assert layer.moe.router.dtype == torch.float32
            assert hasattr(layer, "shared_mlp") == bool(cfg.n_shared_experts)
    assert n == sum(1 for p in params.layers.parameters())


def test_init_params_moe_and_mla_layout_and_scales():
    """The reference's shapes at full deepseek ratios cut small: MLA's
    ``wq`` (d, H, nope + rope), ``wkv_a`` (d, L + rope), ``kv_norm`` (L,)
    zero, ``wkv_b`` (L, H, nope + v), ``wo`` (H, v, d); the experts
    (E, d, 2, F) and (E, F, d) at 1/sqrt(fan-in), the router float32 in a
    bfloat16 model, the shared MLP F · n_shared wide."""
    _, cfg = model_configs("deepseek-v2-lite-16b", "bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    d, h, lat = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    e, f = cfg.n_experts, cfg.d_ff_expert
    attn = params.layers[0].attn
    assert attn.wq.shape == (d, h, nope + rope)
    assert attn.wkv_a.shape == (d, lat + rope)
    assert attn.kv_norm.shape == (lat,) and not attn.kv_norm.any()
    assert attn.wkv_b.shape == (lat, h, nope + v)
    assert attn.wo.shape == (h, v, d)
    assert hasattr(params.layers[0], "mlp")            # first_dense_layers
    layer = params.layers[1]
    assert layer.moe.router.shape == (d, e)
    assert layer.moe.router.dtype == torch.float32
    assert layer.moe.wi.shape == (e, d, 2, f) and layer.moe.wi.dtype == \
        torch.bfloat16
    assert layer.moe.wo.shape == (e, f, d)
    fs = f * cfg.n_shared_experts
    assert layer.shared_mlp.wi.shape == (d, 2, fs)
    assert layer.shared_mlp.wo.shape == (fs, d)
    for t, fan_in in ((layer.moe.router, d), (layer.moe.wi, d),
                      (layer.moe.wo, f), (attn.wkv_b, lat),
                      (attn.wo, h * v)):
        assert abs(float(t.float().std()) * fan_in ** 0.5 - 1.0) < 0.15


@pytest.mark.parametrize("s", [5, 40])
def test_mla_prefill_cache_and_padding_match_reference(s):
    """deepseek reduced in float32: the prefill cache of each layer is
    ``{"latent" (B, S, L), "k_rope" (B, S, rope)}`` equal to the
    reference's within rtol 1e-5 (the normed latent, the roped key);
    ``pad_cache_to`` grows their sequence axis to the serving window with
    zeros past the prompt, as the reference's does, to ``init_cache``'s
    shapes."""
    jax_cfg, jax_params, cfg, params = both_models("deepseek-v2-lite-16b",
                                                   seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, s))
    _, _, jax_cache = jax_forward(jax_params, {"tokens": jnp.asarray(toks)},
                                  jax_cfg, JaxCtx(mode="prefill"))
    _, _, cache = forward(params, {"tokens": torch.from_numpy(toks)}, cfg,
                          ShardCtx(mode="prefill"))
    max_seq = 50
    jax_padded = jax_pad_cache_to(jax_cfg, jax_cache, 2, max_seq)
    padded = pad_cache_to(cfg, cache, 2, max_seq)
    prologue, n_rep, unit, _ = cfg.repeat_structure()
    want = list(jax_padded["prologue"]) + [
        {k: v[r] for k, v in jax_padded["groups"][str(pos)].items()}
        for r in range(n_rep) for pos in range(len(unit))]
    assert len(padded) == len(block_plan(cfg)) == len(want)
    for c, p, z, w in zip(cache, padded, init_cache(cfg, 2, max_seq), want):
        assert sorted(c) == sorted(z) == ["k_rope", "latent"]
        assert c["latent"].shape == (2, s, cfg.kv_lora_rank)
        assert c["k_rope"].shape == (2, s, cfg.qk_rope_dim)
        for k in z:
            assert p[k].shape == z[k].shape == w[k].shape
            assert torch.equal(p[k][:, :s], c[k])
            assert not p[k][:, s:].any()
            np.testing.assert_allclose(p[k].numpy(), np.asarray(w[k]),
                                       rtol=F32_RTOL, atol=F32_RTOL)


def test_mla_decode_refuses_a_position_past_the_cache():
    """The absorbed decode writes at ``pos`` of a linear cache of T
    slots: ``pos >= T`` is refused, as the linear KV cache refuses it."""
    _, cfg = model_configs("deepseek-v2-lite-16b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    cache = init_cache(cfg, 1, 8)
    tok = torch.zeros((1, 1), dtype=torch.long)
    forward(params, {"tokens": tok, "pos": 7, "cache": cache}, cfg,
            ShardCtx(mode="decode"))
    with pytest.raises(IndexError, match="outside"):
        forward(params, {"tokens": tok, "pos": 8, "cache": cache}, cfg,
                ShardCtx(mode="decode"))
