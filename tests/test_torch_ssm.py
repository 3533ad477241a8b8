"""The port's SSM and hybrid serving path on the CPU, held against the JAX
package.

The plain ``ssd_scan`` against the reference's Pallas kernel (interpret
mode) and its ``ssd_chunked`` / ``ssd_sequential`` oracles, the port's
copies of those oracles, the guards of ``ops.ssd_scan``, and reduced
``mamba2-780m`` and ``zamba2-7b`` models against the reference
``forward`` and ``generate`` on the same weights.

Inputs are drawn with NumPy from a seed and fed to both packages. The
reference's own init would hide two faults: ``A_log = 0`` and
``dt_bias = 0`` make every chunk's decay underflow at full size, so a
scan that drops the state carried between chunks still passes, and the
zero LoRA ``b_*`` make the shared block's per-slot LoRA add nothing.
Here ``A`` is drawn in -[1, 16] and dt log-uniform in [1e-3, 1e-1] (the
Mamba-2 paper's init, arXiv:2405.21060), and every LoRA matrix, norm
scale and ``D`` is drawn non-zero. The CUDA kernel itself runs only on
the card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.kernels import ops as jax_ops
from repro.models import ssm as jax_ssm
from repro.models.model import ShardCtx as JaxCtx
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.runtime.serve_loop import generate as jax_generate
from repro.runtime.serve_loop import pad_cache_to as jax_pad_cache_to
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import (MambaLayer, ShardCtx, SharedBlock,
                                block_plan, forward, init_cache, init_params,
                                params_from_reference)
from repro_torch.models import ssm
from repro_torch.models.layers import softcap
from repro_torch.runtime import generate, pad_cache_to

from test_torch_models import as_np, assert_rel, bf16_ulp

F32_REL = 1e-4          # the port against the reference model in float32
BF16_REL = 5e-2         # ... in bfloat16 (see the bf16 model test)
SCAN_TOL = 1e-4         # rtol and atol of the scan against its references

# name -> (reference config, port config) modifications of reduced()
MODELS = {"mamba2-780m": {}, "zamba2-7b": {},
          "zamba2-7b-tail": {"n_layers": 5}}      # 2 groups of 2 + 1 tail


def model_configs(name, dtype="float32", attn_backend=None):
    arch = name.removesuffix("-tail")
    extra = dict(MODELS[name], dtype=dtype)
    if attn_backend:
        extra["attn_backend"] = attn_backend
    return (jax_reduced(JAX_ARCHS[arch]).replace(**extra),
            reduced(ARCHS[arch]).replace(**extra))


def mamba_dt_bias(rng, shape):
    """softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]."""
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    return dt + np.log(-np.expm1(-dt))


def ssm_weights(jax_cfg, seed, emb_scale=0.3, norm_std=0.1):
    """The reference's parameter tree with NumPy leaves drawn from
    ``seed``: matrices N(0, 1)/sqrt(fan_in) (the LoRA's ``b_*`` too),
    the embedding N(0, 1)·emb_scale/sqrt(d), norm scales N(0, norm_std),
    ``A_log`` = log U[1, 16], ``dt_bias`` per Mamba-2's dt init, ``D`` =
    1 + N(0, 0.1). Stacked repeat groups and LoRA slots draw each slot
    alike."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jax_init_params(jax_cfg, jax.random.PRNGKey(0)))

    def leaf(path, spec):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        name = keys[-1]
        stacked = "groups" in keys or "shared_lora" in keys
        core = spec.shape[1:] if stacked else spec.shape
        if name == "A_log":
            x = np.log(rng.uniform(1.0, 16.0, spec.shape))
        elif name == "dt_bias":
            x = mamba_dt_bias(rng, spec.shape)
        elif name == "D":
            x = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        else:
            x = rng.standard_normal(spec.shape)
            if len(core) == 1:
                x = x * norm_std
            elif name == "embed":
                x = x * emb_scale / np.sqrt(core[1])
            else:
                fan_in = core[0] * core[1] if name == "wo" and len(core) == 3 \
                    else core[1] if name == "a" else core[0]
                x = x / np.sqrt(fan_in)
        return x.astype(np.float32).astype(np.dtype(spec.dtype))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_models(name, seed=0, dtype="float32", attn_backend=None):
    jax_cfg, cfg = model_configs(name, dtype, attn_backend)
    tree = ssm_weights(jax_cfg, seed)
    return (jax_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_reference(tree, cfg))


def scan_inputs(seed, b, s, h, p, g, n, dtype=np.float32):
    """x, dt, A, B, C with A in -[1, 16] and dt log-uniform in
    [1e-3, 1e-1] (the carried state stays far from zero)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    A = -rng.uniform(1.0, 16.0, h)
    B = rng.standard_normal((b, s, g, n)) * 0.5
    C = rng.standard_normal((b, s, g, n)) * 0.5
    return (x.astype(np.float32).astype(dtype), dt.astype(np.float32),
            A.astype(np.float32), B.astype(np.float32).astype(dtype),
            C.astype(np.float32).astype(dtype))


def torch_args(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16"
        else torch.float32) for a in arrays]


def assert_close(got, want, tol=SCAN_TOL, what=""):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the scan's plain version against the reference
# ---------------------------------------------------------------------------

SWEEP = [(1, 64, 2, 16, 1, 32, 16), (2, 128, 4, 32, 2, 16, 32),
         (1, 256, 8, 64, 1, 64, 64)]          # tests/test_kernels.py


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
def test_plain_scan_matches_reference_pallas_kernel(b, s, h, p, g, n, chunk):
    """The reference's own sweep shapes (its Pallas kernel takes only S a
    multiple of chunk), its Pallas ``ssd_scan`` in interpret mode, float32
    at rtol/atol 1e-4 (the reference's tolerance for the kernel)."""
    arrays = scan_inputs(s + h, b, s, h, p, g, n)
    want_y, want_state = jax_ops.ssd_scan(*map(jnp.asarray, arrays), chunk)
    got_y, got_state = ops.ssd_scan(*torch_args(arrays), chunk)
    assert got_y.dtype == torch.float32 and got_state.shape == (b, h, p, n)
    assert_close(got_y, want_y, what="y")
    assert_close(got_state, want_state, what="state")
    assert float(np.abs(as_np(want_state)).max()) > 0.1    # a live carry


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP + [
    (2, 100, 4, 8, 2, 16, 32),      # ragged: 3 chunks + 4
    (1, 37, 4, 16, 1, 16, 256),     # S < chunk
    (2, 1, 2, 8, 1, 8, 16),         # one position
    (1, 70, 6, 8, 3, 8, 7),         # chunk 7, three groups
])
def test_plain_scan_matches_chunked_and_sequential(b, s, h, p, g, n, chunk):
    """Any S, against the reference's ``ssd_chunked`` (which pads the
    ragged tail with dt = 0) and the token-level ``ssd_sequential``,
    float32 at 1e-4; the port's copies of both against the reference's."""
    arrays = scan_inputs(s * 3 + g, b, s, h, p, g, n)
    got_y, got_state = ops.ssd_scan(*torch_args(arrays), chunk)
    jargs = list(map(jnp.asarray, arrays))
    for fn, port_fn in (
            (lambda *a: jax_ssm.ssd_chunked(*a, chunk),
             lambda *a: ssm.ssd_chunked(*a, chunk)),
            (jax_ssm.ssd_sequential, ssm.ssd_sequential)):
        want_y, want_state = fn(*jargs)
        assert_close(got_y, want_y, what="y")
        assert_close(got_state, want_state, what="state")
        copy_y, copy_state = port_fn(*torch_args(arrays))
        assert_close(copy_y, want_y, 1e-5, "port oracle y")
        assert_close(copy_state, want_state, 1e-5, "port oracle state")


def test_chunked_initial_state_and_decode_step_match_reference():
    """The port's ``ssd_chunked`` with an ``initial_state`` (ragged S) and
    ``ssd_decode_step`` against the reference's, float32 at 1e-5."""
    b, s, h, p, g, n = 2, 45, 4, 8, 2, 16
    arrays = scan_inputs(17, b, s, h, p, g, n)
    init = np.random.default_rng(18).standard_normal(
        (b, h, p, n)).astype(np.float32)
    want = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), 16,
                               initial_state=jnp.asarray(init))
    got = ssm.ssd_chunked(*torch_args(arrays), 16,
                          initial_state=torch.from_numpy(init))
    for g_, w_ in zip(got, want):
        assert_close(g_, w_, 1e-5)
    x, dt, A, B, C = arrays
    x, dt, B, C = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    want = jax_ssm.ssd_decode_step(jnp.asarray(init), *map(jnp.asarray,
                                                           (x, dt, A, B, C)))
    got = ssm.ssd_decode_step(torch.from_numpy(init),
                              *torch_args((x, dt, A, B, C)))
    for g_, w_ in zip(got, want):
        assert_close(g_, w_, 1e-5)


def test_bf16_rounding_split_between_kernel_and_chunked_form():
    """In bfloat16 the TPU kernel keeps M, y and the state in float32 and
    rounds once; ``ssd_chunked`` casts M and the decay weights to
    bfloat16 before its products and rounds the diagonal and
    off-diagonal parts apart. The plain version sides with the kernel:
    at most 2 bfloat16 ulps (of max(|y|, max|y| / 256)) from the Pallas
    kernel in interpret mode, while the chunked form is further off in a
    sizeable share of the outputs (pinned: more than 2 ulps in over 1 %
    of them, and over 8 ulps somewhere)."""
    import ml_dtypes
    b, s, h, p, g, n, chunk = 2, 128, 4, 32, 1, 32, 32
    arrays = scan_inputs(5, b, s, h, p, g, n, ml_dtypes.bfloat16)
    got_y, _ = ops.ssd_scan(*torch_args(arrays), chunk)
    assert got_y.dtype == torch.bfloat16
    kern_y, _ = jax_ops.ssd_scan(*map(jnp.asarray, arrays), chunk)
    chunked_y, _ = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), chunk)
    got = as_np(got_y)

    def ulps(want):
        want = as_np(want)
        floor = np.abs(want).max() / 256
        return np.abs(got - want) / bf16_ulp(np.maximum(np.abs(want), floor))
    assert ulps(kern_y).max() <= 2
    split = ulps(chunked_y)
    assert (split > 2).mean() > 0.01 and split.max() > 8


def test_ssd_scan_entry_point_guards():
    x, dt, A, B, C = torch_args(scan_inputs(0, 1, 10, 4, 8, 2, 16))
    before = ops.ssd_scan.launches
    bad = [
        (TypeError, lambda: ops.ssd_scan(x.double(), dt, A, B, C)),
        (TypeError, lambda: ops.ssd_scan(x, dt.bfloat16(), A, B, C)),
        (TypeError, lambda: ops.ssd_scan(x, dt, A.double(), B, C)),
        (TypeError, lambda: ops.ssd_scan(x, dt, A, B.bfloat16(), C)),
        (ValueError, lambda: ops.ssd_scan(x, dt[:, :9].contiguous(), A, B,
                                          C)),
        (ValueError, lambda: ops.ssd_scan(x, dt, A[:3], B, C)),
        (ValueError, lambda: ops.ssd_scan(x, dt, A, B, C[..., :8]
                                          .contiguous())),
        (ValueError, lambda: ops.ssd_scan(x, dt, A, B[:, :, :1]
                                          .contiguous(), C)),
        (ValueError, lambda: ops.ssd_scan(x[0], dt, A, B, C)),
        (ValueError, lambda: ops.ssd_scan(x.transpose(1, 2).contiguous()
                                          .transpose(1, 2), dt, A, B, C)),
        (ValueError, lambda: ops.ssd_scan(x, dt, A.to("meta"), B, C)),
        (ValueError, lambda: ops.ssd_scan(x, dt, A, B, C, 0)),
        (ValueError, lambda: ops.ssd_scan(x, dt, A, B, C, 2.5)),
    ]
    three = torch_args(scan_inputs(1, 1, 10, 4, 8, 3, 16))
    bad.append((ValueError, lambda: ops.ssd_scan(*three)))   # 3 ∤ 4 heads
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    y, state = ops.ssd_scan(x, dt, A, B, C, 4)
    assert torch.equal(y, ssd.ssd_scan_torch(x, dt, A, B, C, 4)[0])
    empty = [t[:, :0].contiguous() for t in (x, dt)] + [A] + \
        [t[:, :0].contiguous() for t in (B, C)]
    y0, s0 = ops.ssd_scan(*empty)
    assert y0.shape == (1, 0, 4, 8) and not s0.any()
    assert ops.ssd_scan.launches == before       # the CPU never launches


def test_plain_version_takes_shapes_past_the_kernels_limits():
    """The kernel's limits on P and N are the card's: a CPU tensor runs
    the plain version past them (without loading the library), float32
    against the port's ``ssd_sequential`` at 1e-4."""
    args = torch_args(scan_inputs(9, 1, 40, 2, 72, 1, 136))
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, 16)
    want_y, want_state = ssm.ssd_sequential(*args)
    assert state.shape == (1, 2, 72, 136)
    assert_close(y, want_y, what="y")
    assert_close(state, want_state, what="state")
    assert ops.ssd_scan.launches == before


# ---------------------------------------------------------------------------
# the models against the reference models
# ---------------------------------------------------------------------------

PROMPT, STEPS = 40, 4        # 5 chunks of the reduced ssm_chunk (8)


def reference_backend(name):
    """mamba2 prefills through the reference's Pallas ssd_scan (the
    prompt is a multiple of ssm_chunk); zamba2 through its xla path, as
    the reference's Pallas flash_attention does not run on JAX 0.9.0."""
    return "pallas" if name == "mamba2-780m" else "xla"


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_reference_through_prefill_and_decode(name):
    """Train-mode logits, prefill logits and teacher-forced decode steps
    in float32, within 1e-4 of the reference's largest logit."""
    jax_cfg, jax_params, cfg, params = both_models(
        name, seed=1, attn_backend=reference_backend(name))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, PROMPT + STEPS))
    prompt = toks[:, :PROMPT]

    want, _ = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="train")))(
            jax_params, jnp.asarray(prompt))
    got, aux = forward(params, {"tokens": torch.from_numpy(prompt)}, cfg,
                       ShardCtx(mode="train"))
    assert_rel(got, want, F32_REL, "train logits")
    assert float(aux) == 0.0

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


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_cache_matches_reference(name):
    """The conv tails, the final SSM states and the shared block's K/V
    of a ragged prompt (not a multiple of the chunk) equal the
    reference's, float32 at 1e-4, block by block of the plan."""
    jax_cfg, jax_params, cfg, params = both_models(name, seed=12)
    prompt = np.random.default_rng(13).integers(0, cfg.vocab, (2, 21))
    _, _, jax_cache = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="prefill")))(
            jax_params, jnp.asarray(prompt))
    _, _, cache = forward(params, {"tokens": torch.from_numpy(prompt)}, cfg,
                          ShardCtx(mode="prefill"))
    _, n_rep, unit, _ = cfg.repeat_structure()
    for entry, (what, i) in zip(cache, block_plan(cfg)):
        if what == "shared":
            want = jax.tree.map(lambda a, r=i: a[r],
                                jax_cache["groups"]["shared"])
        elif i < n_rep * len(unit):
            r, pos = divmod(i, len(unit))
            want = jax.tree.map(lambda a, r=r: a[r],
                                jax_cache["groups"][str(pos)])
        else:
            want = jax_cache["tail"][i - n_rep * len(unit)]
        assert sorted(entry) == sorted(want)
        for k in entry:
            assert_rel(entry[k], want[k], F32_REL, f"{what} {i} {k}")


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_tokens_match_reference(name):
    jax_cfg, jax_params, cfg, params = both_models(name, seed=3)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 27))
    want = np.asarray(jax_generate(jax_cfg, JaxCtx(), jax_params,
                                   {"tokens": jnp.asarray(prompt)}, 6))
    got = generate(cfg, ShardCtx(), params,
                   {"tokens": torch.from_numpy(prompt)}, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2, "degenerate greedy tokens"


@pytest.mark.parametrize("name", list(MODELS))
def test_streaming_consistency(name):
    """prefill(x[:s]) + decode(x[s]) == forward(x[:s+1])'s last two
    logits, the identity of the reference's ``test_streaming_
    consistency``, at its tolerances (the decode recurrence against the
    chunked scan)."""
    _, cfg = model_configs(name)
    _, _, _, params = both_models(name, seed=5)
    s = 29
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


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_bf16_model_matches_reference_at_a_looser_tolerance(name):
    """In bfloat16: prefill and two decode steps within 5e-2 of the
    reference's largest logit. Both round every activation to bfloat16,
    at places that differ: the port's scan rounds once where the
    reference's ``ssd_chunked`` rounds M, the decay weights and two
    partial sums (see the rounding-split test), and its attention keeps
    scores and probabilities in float32."""
    jax_cfg, jax_params, cfg, params = both_models(name, seed=7,
                                                   dtype="bfloat16")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (2, PROMPT))
    want, _, jax_cache = jax.jit(lambda p, t: jax_forward(
        p, {"tokens": t}, jax_cfg, JaxCtx(mode="prefill")))(
            jax_params, jnp.asarray(prompt))
    got, _, cache = forward(params, {"tokens": torch.from_numpy(prompt)},
                            cfg, ShardCtx(mode="prefill"))
    assert got.dtype == torch.bfloat16
    assert_rel(got, want, BF16_REL, "bf16 prefill logits")
    jax_cache = jax_pad_cache_to(jax_cfg, jax_cache, 2, PROMPT + 2)
    cache = pad_cache_to(cfg, cache, 2, PROMPT + 2)
    for pos in (PROMPT, PROMPT + 1):
        tok = np.argmax(as_np(want), axis=-1)[:, None]
        want, _, jax_cache = jax_forward(
            jax_params, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
                         "cache": jax_cache}, jax_cfg, JaxCtx(mode="decode"))
        got, _, cache = forward(params, {"tokens": torch.from_numpy(tok),
                                         "pos": pos, "cache": cache}, cfg,
                                ShardCtx(mode="decode"))
        assert_rel(got, want, BF16_REL, f"bf16 decode logits at {pos}")


def test_init_params_follows_the_reference_scales():
    _, cfg = model_configs("zamba2-7b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    layer = params.layers[0]
    assert isinstance(layer, MambaLayer)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    assert layer.wx.shape == (d, di) and layer.wB.shape == (d, gn)
    assert layer.conv_x.shape == (cfg.ssm_conv, di)
    assert layer.wdt.shape == (d, h) and layer.wout.shape == (di, d)
    assert all(t.dtype == torch.float32 and t.shape == (h,)
               for t in (layer.A_log, layer.dt_bias, layer.D))
    assert not layer.A_log.any() and not layer.dt_bias.any()
    assert torch.equal(layer.D, torch.ones(h))
    assert not layer.ln.any() and not layer.gate_norm.any()
    shared = params.shared
    assert isinstance(shared, SharedBlock)
    _, n_rep, _, _ = cfg.repeat_structure()
    assert len(shared.lora) == n_rep
    assert shared.attn.wq.shape == (2 * d, cfg.n_heads, cfg.head_dim)
    assert shared.down.shape == (2 * d, d)
    lora = shared.lora[0]
    assert lora.a.shape == (3, 2 * d, cfg.shared_lora_rank)
    assert not any(t.any() for t in (lora.b_q, lora.b_k, lora.b_v))
    for t, fan_in in ((layer.wx, d), (layer.wout, di),
                      (layer.conv_x, cfg.ssm_conv),
                      (shared.attn.wq, 2 * d), (shared.down, 2 * d),
                      (lora.a, 2 * d)):
        assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.15, t.shape
    assert not any(p.requires_grad for p in params.parameters())
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))


@pytest.mark.parametrize("name", list(MODELS))
def test_block_plan_and_cache_layout(name):
    """One cache entry per block of the plan, in the reference's cache
    shapes and ``cfg.dtype``; the shared block heads each group and
    never the tail."""
    jax_cfg, cfg = model_configs(name)
    plan = block_plan(cfg)
    _, n_rep, unit, tail = cfg.repeat_structure()
    assert [i for w, i in plan if w == "layer"] == list(range(cfg.n_layers))
    shared_at = [j for j, (w, _) in enumerate(plan) if w == "shared"]
    if cfg.shared_attn_every:
        assert shared_at == [r * (len(unit) + 1) for r in range(n_rep)]
        assert all(w == "layer" for w, _ in plan[-len(tail):]) if tail \
            else True
    else:
        assert not shared_at
    from repro.models.model import init_cache as jax_init_cache
    want = jax_init_cache(jax_cfg, 2, 30)
    for entry, (what, i) in zip(init_cache(cfg, 2, 30), plan):
        if what == "shared":
            ref = want["groups"]["shared"]
            shapes = {k: v.shape[1:] for k, v in ref.items()}
        elif i < n_rep * len(unit):
            ref = want["groups"][str(i % len(unit))]
            shapes = {k: v.shape[1:] for k, v in ref.items()}
        else:
            shapes = {k: v.shape for k, v in
                      want["tail"][i - n_rep * len(unit)].items()}
        assert {k: tuple(v.shape) for k, v in entry.items()} == \
            {k: tuple(s) for k, s in shapes.items()}
        assert all(v.dtype == torch.float32 for v in entry.values())


def test_mamba_prefill_ignores_attn_backend():
    """The prefill runs ``ops.ssd_scan`` whatever ``attn_backend`` says
    (the port has one path), so both settings give the same logits."""
    _, cfg = model_configs("mamba2-780m")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 19)))
    outs = [forward(params, {"tokens": toks}, cfg.replace(attn_backend=b),
                    ShardCtx(mode="prefill"))[0] for b in ("xla", "pallas")]
    assert torch.equal(*outs)
