"""The port's serving model on the CPU, held against the JAX package.

Plain versions of the three kernels of the serving path (``rmsnorm``,
``flash_attention``, ``flash_decode``) against the reference's Pallas
kernels in interpret mode and its pure-jnp oracles; the dense model
(reduced ``gemma-2b``, ``gemma2-2b``, ``gemma3-4b``, ``glm4-9b`` and
``demo-20m``) and the MoE family (reduced ``deepseek-v2-lite-16b``, MoE
with MLA, and ``qwen3-moe-235b-a22b``, MoE with GQA and qk-norm) against
the reference ``forward`` and ``generate`` on the same weights; the
guards of the entry points; the frontends the port does not serve yet.

Weights are drawn with NumPy from a seed and fed to both packages. The
reference's own init (zero norms, a 1/sqrt(d) embedding tied to the
head) makes greedy decoding copy its last token, so equal tokens would
prove little: here every norm scale is N(0, 0.1) and the embedding is
drawn at 0.3/sqrt(d), which gives varied tokens, and the tests compare
logits, not only tokens. The CUDA kernels themselves run only on the
card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.configs.demo import DEMO_20M as JAX_DEMO_20M
from repro.kernels import ops as jax_ops
from repro.kernels.ref import decode_attention_ref, flash_attention_ref
from repro.models import layers as jax_layers
from repro.models.model import ShardCtx as JaxCtx
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.runtime.serve_loop import generate as jax_generate
from repro.runtime.serve_loop import pad_cache_to as jax_pad_cache_to
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.demo import DEMO_20M
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import (ShardCtx, forward, init_params,
                                params_from_reference)
from repro_torch.models.convert import to_tensor
from repro_torch.models.layers import rms_norm
from repro_torch.runtime import generate, pad_cache_to

DENSE = ["gemma-2b", "gemma2-2b", "gemma3-4b", "glm4-9b", "demo-20m"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
F32_REL = 1e-4          # the port against the reference model in float32


def model_configs(name, dtype="float32"):
    """(reference config, port config): the reduced same-family variant."""
    jax_cfg = JAX_DEMO_20M if name == "demo-20m" else JAX_ARCHS[name]
    cfg = DEMO_20M if name == "demo-20m" else ARCHS[name]
    return (jax_reduced(jax_cfg).replace(dtype=dtype),
            reduced(cfg).replace(dtype=dtype))


def reference_weights(jax_cfg, seed, emb_scale=0.3, norm_std=0.1):
    """The reference's parameter tree with NumPy leaves drawn from
    ``seed``: matrices N(0, 1)/sqrt(fan_in) (an expert's ``wi`` (E, d, 2,
    F) and ``wo`` (E, F, d) by the fan-in of one expert), the embedding
    N(0, 1)·emb_scale/sqrt(d), every vector (norm scales, MLA's
    ``kv_norm``) N(0, norm_std); each leaf in its own type (a MoE router
    stays float32 in a bfloat16 model); stacked repeat groups draw each
    repeat alike."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jax_init_params(jax_cfg, jax.random.PRNGKey(0)))

    def leaf(path, spec):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        core = spec.shape[1:] if "groups" in keys else spec.shape
        x = rng.standard_normal(spec.shape)
        if len(core) == 1:
            x = x * norm_std
        elif keys[-1] == "embed":
            x = x * emb_scale / np.sqrt(core[1])
        elif "moe" in keys and keys[-1] in ("wi", "wo"):
            x = x / np.sqrt(core[1])
        else:
            fan_in = core[0] * core[1] if keys[-1] == "wo" and len(core) == 3 \
                else core[0]
            x = x / np.sqrt(fan_in)
        return x.astype(np.float32).astype(np.dtype(spec.dtype))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_models(name, seed=0, dtype="float32"):
    jax_cfg, cfg = model_configs(name, dtype)
    tree = reference_weights(jax_cfg, seed)
    return (jax_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_reference(tree, cfg))


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def assert_rel(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > " \
                               f"{rel} x {scale:.3e}"


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def tensor(a):
    return to_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# plain kernel versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_centered", [True, False])
@pytest.mark.parametrize("shape", [(3, 37, 64), (64, 2304), (1, 16)])
def test_rmsnorm_plain_matches_reference_kernel(dtype, zero_centered, shape):
    """The plain version against the Pallas kernel (interpret mode):
    float32 within a few ulps (the sum of squares is reduced in another
    order: rtol 2e-6, atol 1e-6); bfloat16 at most one bfloat16 ulp
    apart, where that float32 difference rounds across a boundary."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = jnp.asarray(rng.standard_normal(shape), dtype)
    w = jnp.asarray(rng.standard_normal(shape[-1]) * 0.1, dtype)
    want = jax_ops.rmsnorm(x, w, zero_centered=zero_centered)
    got = rn.rmsnorm_torch(tensor(x), tensor(w), zero_centered=zero_centered)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    got, want = as_np(got), as_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all()
    assert ops.rmsnorm(tensor(x), tensor(w),
                       zero_centered=zero_centered).shape == shape


def test_model_norm_call_form_matches_reference_layer_in_bf16():
    """The model's call, ``rmsnorm((1 + w).to(bf16), zero_centered=
    False)``, reproduces ``layers.rms_norm`` in bfloat16: bit-equal
    except where the float32 sum of squares, reduced in another order,
    rounds across a bfloat16 boundary (at most 1 ulp, in at most 0.01 %
    of the elements; 1 of 147,456 here). The kernel's own zero-centred
    form, which adds 1 + w in float32, differs in about a quarter of
    them: the reason the model does not use it."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((64, 2304)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(2304) * 0.1, jnp.bfloat16)
    want = as_np(jax_layers.rms_norm(x, w))
    got = as_np(rms_norm(tensor(x), tensor(w)))
    assert (np.abs(got - want) <= bf16_ulp(want)).all()
    assert (got != want).mean() <= 1e-4
    kernel_form = as_np(rn.rmsnorm_torch(tensor(x), tensor(w),
                                         zero_centered=True))
    assert (kernel_form != want).mean() > 0.1


@pytest.mark.parametrize("b,s,hq,hkv,d,window,softcap", [
    (2, 100, 4, 2, 16, None, None),      # causal, ragged S, GQA
    (1, 77, 4, 1, 32, 16, None),         # window 16, MQA
    (2, 130, 4, 2, 16, 64, 50.0),        # window 64 + softcap
    (1, 64, 8, 4, 32, None, 50.0),       # softcap
    (1, 1, 2, 1, 16, 16, 50.0),          # a single token
])
def test_flash_attention_plain_matches_reference(b, s, hq, hkv, d, window,
                                                 softcap):
    """Against ``flash_attention_ref`` (the model's xla path: streamed or
    windowed attention), float32 at 1e-5. The reference's Pallas kernel
    itself does not run on the installed JAX (``pl.load`` is gone)."""
    rng = np.random.default_rng(s * 10 + hq)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, softcap=softcap)
    got = fa.flash_attention_torch(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    via_ops = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=window, softcap=softcap)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("b,t,hq,hkv,d,ring,softcap,pos", [
    (2, 100, 4, 2, 32, False, None, [37, 99]),     # linear, padded blocks
    (1, 200, 8, 1, 64, False, 30.0, [0]),          # linear, softcap, MQA
    (2, 128, 4, 4, 32, True, None, [60, 300]),     # ring, not yet / wrapped
    (3, 16, 4, 2, 16, True, 50.0, [15, 16, 40]),   # ring, softcap
])
def test_flash_decode_plain_matches_reference(b, t, hq, hkv, d, ring,
                                              softcap, pos):
    """Against the Pallas kernel (interpret mode, kv_block 64) and
    ``decode_attention_ref`` (the model's decode mask), float32 at the
    reference's own 2e-5."""
    rng = np.random.default_rng(t + hq)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
              for _ in range(2))
    p = np.asarray(pos, np.int32)
    got = fd.flash_decode_torch(*map(torch.from_numpy, (q, kc, vc, p)),
                                softcap=softcap, ring=ring)
    for want in (jax_ops.flash_decode(q, kc, vc, jnp.asarray(p), ring=ring,
                                      softcap=softcap, kv_block=64),
                 decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(p),
                                      ring=ring, softcap=softcap)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    via_ops = ops.flash_decode(*map(torch.from_numpy, (q, kc, vc, p)),
                               softcap=softcap, ring=ring)
    assert torch.equal(via_ops, got)


def test_linear_cache_position_past_the_end_is_refused():
    """The reference wrapper accepts ``pos == T`` on a linear cache, and
    its kernel then lets one zero padding slot into the softmax (T=100,
    kv_block=64: off by more than 1e-3). The port's entry point refuses
    that position, and a negative one, on a linear or ring cache."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((1, 100, 2, 32)).astype(np.float32)
              for _ in range(2))
    at_t = jnp.asarray([100], jnp.int32)
    ref_err = np.abs(
        np.asarray(jax_ops.flash_decode(q, kc, vc, at_t, kv_block=64))
        - np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                                          jnp.asarray(vc), at_t))).max()
    assert ref_err > 1e-3
    args = list(map(torch.from_numpy, (q, kc, vc)))
    with pytest.raises(IndexError, match="outside"):
        ops.flash_decode(*args, torch.tensor([100], dtype=torch.int32))
    for ring in (False, True):
        with pytest.raises(IndexError, match="outside"):
            ops.flash_decode(*args, torch.tensor([-1], dtype=torch.int32),
                             ring=ring)
    ops.flash_decode(*args, torch.tensor([99], dtype=torch.int32))
    ops.flash_decode(*args, torch.tensor([500], dtype=torch.int32),
                     ring=True)


def _attn_args(dtype=torch.float32, hq=4, hkv=2):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype) for shape in
            ((2, 10, hq, 16), (2, 10, hkv, 16), (2, 10, hkv, 16))]


def test_entry_points_reject_what_their_kernels_do_not_take():
    q, k, v = _attn_args()
    w = torch.zeros(16)
    bad = [
        (TypeError, lambda: ops.rmsnorm(q.double(), w)),
        (TypeError, lambda: ops.rmsnorm(q.long(), w)),
        (ValueError, lambda: ops.rmsnorm(q, torch.zeros(15))),
        (ValueError, lambda: ops.rmsnorm(q.transpose(1, 2), w)),
        (ValueError, lambda: ops.rmsnorm(q, w.to("meta"))),
        (ValueError, lambda: ops.rmsnorm(q.to("meta"), w.to("meta"))),
        (TypeError, lambda: ops.flash_attention(q, k.bfloat16(), v)),
        (TypeError, lambda: ops.flash_attention(q.half(), k.half(),
                                                v.half())),
        (ValueError, lambda: ops.flash_attention(q, k[:, :9], v)),
        (ValueError, lambda: ops.flash_attention(q, k, v[..., :8]
                                                 .contiguous()[:, :9])),
        (ValueError, lambda: ops.flash_attention(*_attn_args(hq=3))),
        (ValueError, lambda: ops.flash_attention(q, k, v, window=0)),
        (ValueError, lambda: ops.flash_attention(q, k, v, softcap=0.0)),
        (ValueError, lambda: ops.flash_attention(q[0], k[0], v[0])),
        (ValueError, lambda: ops.flash_attention(q, k, v.to("meta"))),
        (ValueError, lambda: ops.flash_attention(q.transpose(1, 2)
                                                 .contiguous()
                                                 .transpose(1, 2), k, v)),
    ]
    pos = torch.tensor([3, 4], dtype=torch.int32)
    q1 = q[:, 0].contiguous()
    bad += [
        (TypeError, lambda: ops.flash_decode(q1, k, v, pos.long())),
        (TypeError, lambda: ops.flash_decode(q1, k, v.bfloat16(), pos)),
        (ValueError, lambda: ops.flash_decode(q1, k, v, pos[:1])),
        (ValueError, lambda: ops.flash_decode(q1[:1], k, v, pos)),
        (ValueError, lambda: ops.flash_decode(q[:, 0], k, v, pos)),
        (ValueError, lambda: ops.flash_decode(q1, k, v, pos.to("meta"))),
        (ValueError, lambda: ops.flash_decode(q1, k[:, :0].contiguous(),
                                              v[:, :0].contiguous(), pos)),
        (ValueError, lambda: ops.flash_decode(q1, k, v, pos, softcap=-1.0)),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    # on the card, the bfloat16 kernel's TMA loads also need head dims that
    # are multiples of 8 and 16-byte aligned tensors (the library's rule,
    # held on the card by test_torch_cuda.py); the CPU runs the plain
    # version, which needs neither
    flat = torch.zeros(3 * 40 * 20 + 1, dtype=torch.bfloat16)
    ops.flash_attention(*[flat[1 + i * 800:1 + (i + 1) * 800]
                          .view(1, 10, 4, 20) for i in range(3)])


def test_cpu_calls_run_the_plain_versions_without_counting():
    q, k, v = _attn_args()
    pos = torch.tensor([3, 9], dtype=torch.int32)
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    assert torch.equal(ops.rmsnorm(q, torch.zeros(16)),
                       rn.rmsnorm_torch(q, torch.zeros(16)))
    assert torch.equal(ops.flash_attention(q, k, v, window=4),
                       fa.flash_attention_torch(q, k, v, window=4))
    q1 = q[:, 0].contiguous()
    assert torch.equal(ops.flash_decode(q1, k, v, pos, ring=True),
                       fd.flash_decode_torch(q1, k, v, pos, ring=True))
    assert (ops.rmsnorm.launches, ops.flash_attention.launches,
            ops.flash_decode.launches) == counts


# ---------------------------------------------------------------------------
# the model against the reference model
# ---------------------------------------------------------------------------

PROMPT, STEPS = 40, 4        # prompt longer than the reduced window (16)


@pytest.mark.parametrize("name", DENSE + MOE)
def test_logits_match_reference_through_prefill_and_decode(name):
    """Train-mode logits, prefill logits and four teacher-forced decode
    steps past the window (the local layers' ring caches wrap; MLA
    decodes in the absorbed form), in float32, within 1e-4 of the
    reference's largest logit; the aux loss equal to the reference's
    within rtol 1e-5 (exactly 0 without MoE layers)."""
    jax_cfg, jax_params, cfg, params = both_models(name, seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, PROMPT + STEPS))
    prompt = toks[:, :PROMPT]

    want, want_aux = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="train")))(
            jax_params, jnp.asarray(prompt))
    got, aux = forward(params, {"tokens": torch.from_numpy(prompt)}, cfg,
                       ShardCtx(mode="train"))
    assert_rel(got, want, F32_REL, "train logits")
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    assert (float(aux) > 0.0) == (name in MOE)

    prefill = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="prefill")))
    step = jax.jit(lambda p, c, t, pos: jax_forward(
        p, {"tokens": t, "pos": pos, "cache": c}, jax_cfg,
        JaxCtx(mode="decode")))
    max_seq = PROMPT + STEPS
    want, _, jax_cache = prefill(jax_params, jnp.asarray(prompt))
    jax_cache = jax_pad_cache_to(jax_cfg, jax_cache, 2, max_seq)
    got, _, cache = forward(params, {"tokens": torch.from_numpy(prompt)},
                            cfg, ShardCtx(mode="prefill"))
    cache = pad_cache_to(cfg, cache, 2, max_seq)
    assert_rel(got, want, F32_REL, "prefill logits")
    for i in range(STEPS - 1):
        pos = PROMPT + i
        tok = toks[:, pos:pos + 1]
        want, _, jax_cache = step(jax_params, jax_cache, jnp.asarray(tok),
                                  jnp.asarray(pos))
        got, _, cache = forward(params, {"tokens": torch.from_numpy(tok),
                                         "pos": pos, "cache": cache},
                                cfg, ShardCtx(mode="decode"))
        assert_rel(got, want, F32_REL, f"decode logits at {pos}")


@pytest.mark.parametrize("name", DENSE + MOE)
def test_generate_tokens_match_reference(name):
    jax_cfg, jax_params, cfg, params = both_models(name, seed=3)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, PROMPT))
    want = np.asarray(jax_generate(jax_cfg, JaxCtx(), jax_params,
                                   {"tokens": jnp.asarray(prompt)}, 6))
    got = generate(cfg, ShardCtx(), params,
                   {"tokens": torch.from_numpy(prompt)}, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2, "degenerate greedy tokens"


@pytest.mark.parametrize("name", DENSE + MOE)
def test_streaming_consistency(name):
    """prefill(x[:s]) + decode(x[s]) == forward(x[:s+1])'s last two
    logits (softcapped as the serve path returns them), the identity of
    the reference's ``test_streaming_consistency``, at its tolerances.
    Under MLA it holds the absorbed decode to the materialised
    attention of the train forward."""
    from repro_torch.models.layers import softcap
    _, cfg = model_configs(name)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    s = 32
    full = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, s)))
    logits, _ = forward(params, {"tokens": full}, cfg, ShardCtx(mode="train"))
    logits = softcap(logits, cfg.logit_softcap)
    last, _, cache = forward(params, {"tokens": full[:, :-1]}, cfg,
                             ShardCtx(mode="prefill"))
    np.testing.assert_allclose(last.numpy(), logits[:, -2].numpy(),
                               atol=2e-4, rtol=2e-4)
    cache = pad_cache_to(cfg, cache, 2, s + 8)
    dec, _, _ = forward(params, {"tokens": full[:, -1:], "pos": s - 1,
                                 "cache": cache}, cfg,
                        ShardCtx(mode="decode"))
    np.testing.assert_allclose(dec.numpy(), logits[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def test_bf16_model_matches_reference_at_a_looser_tolerance():
    """gemma2-2b reduced in bfloat16: prefill and decode logits within
    5e-2 of the reference's largest logit. Both round every activation
    to bfloat16, at places that differ (the reference's einsums round
    scores and probabilities to bfloat16 before the float32 softmax and
    the PV product; the port's kernels keep both in float32)."""
    bf16_prefill_and_decode("gemma2-2b", seed=7)


def test_bf16_moe_mla_model_matches_reference_at_a_looser_tolerance():
    """deepseek-v2-lite-16b reduced in bfloat16 (MLA, a dense layer, MoE
    layers with a float32 router): prefill and one absorbed decode step
    within 5e-2 of the reference's largest logit."""
    bf16_prefill_and_decode("deepseek-v2-lite-16b", seed=7)


def bf16_prefill_and_decode(name, seed):
    jax_cfg, jax_params, cfg, params = both_models(name, seed=seed,
                                                   dtype="bfloat16")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (2, PROMPT))
    want, _, jax_cache = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="prefill")))(
            jax_params, jnp.asarray(prompt))
    got, _, cache = forward(params, {"tokens": torch.from_numpy(prompt)},
                            cfg, ShardCtx(mode="prefill"))
    assert got.dtype == torch.bfloat16
    assert_rel(got, want, 5e-2, "bf16 prefill logits")
    jax_cache = jax_pad_cache_to(jax_cfg, jax_cache, 2, PROMPT + 2)
    cache = pad_cache_to(cfg, cache, 2, PROMPT + 2)
    tok = np.argmax(as_np(want), axis=-1)[:, None]
    want, _, _ = jax_forward(jax_params, {"tokens": jnp.asarray(tok),
                                          "pos": jnp.asarray(PROMPT),
                                          "cache": jax_cache},
                             jax_cfg, JaxCtx(mode="decode"))
    got, _, _ = forward(params, {"tokens": torch.from_numpy(tok),
                                 "pos": PROMPT, "cache": cache}, cfg,
                        ShardCtx(mode="decode"))
    assert_rel(got, want, 5e-2, "bf16 decode logits")


def test_init_params_follows_the_reference_scales():
    _, cfg = model_configs("gemma2-2b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    layer = params.layers[0]
    assert layer.attn.wq.shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert layer.attn.wo.shape == (cfg.n_heads, cfg.head_dim, cfg.d_model)
    assert layer.mlp.wi.shape == (cfg.d_model, 2, cfg.d_ff)
    assert all(not float(t.abs().max()) for t in
               (layer.ln1, layer.ln2, layer.post_ln1, layer.post_ln2,
                params.final_norm))
    for t, fan_in in ((params.embed, cfg.d_model),
                      (layer.attn.wq, cfg.d_model),
                      (layer.attn.wo, cfg.n_heads * cfg.head_dim),
                      (layer.mlp.wo, cfg.d_ff)):
        assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert not any(p.requires_grad for p in params.parameters())
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))


@pytest.mark.parametrize("name", ["hubert-xlarge", "paligemma-3b"])
def test_families_of_later_slices_raise(name):
    """The patch/frame frontends belong to a later slice of the port
    (Mamba-2 and Zamba-2 are served: ``test_torch_ssm.py``; MoE and MLA
    above and in ``test_torch_moe.py``)."""
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    with pytest.raises(NotImplementedError, match="slice"):
        init_params(cfg, torch.Generator().manual_seed(0))


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="sharding"):
        ShardCtx(mesh=object())
