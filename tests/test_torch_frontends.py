"""The patch and frame frontends of the port on the CPU, held against
the JAX package.

The prefix-LM mask of ``flash_attention``'s plain version against the
reference's ``attention_streamed`` prefix branch; reduced paligemma-3b
(the VLM: patches projected and put before the tokens, the prefix-LM
mask over them, decode from ``S + n_patches``) through ``generate`` and
the prefill; reduced hubert-xlarge (the encoder: frames projected,
bidirectional attention, gelu, an untied head) through ``forward``; the
serve CLI with a patch prompt, and its refusal of the frame frontend.
Weights are drawn with NumPy (``test_torch_models.reference_weights``)
and fed to both packages. The CUDA kernels run only on the card
(``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models.model import ShardCtx as JaxCtx
from repro.models.model import forward as jax_forward
from repro.runtime.serve_loop import generate as jax_generate
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ShardCtx, forward
from repro_torch.runtime import generate

from test_torch_models import assert_rel, both_models

F32_REL = 1e-4          # the port against the reference model in float32


def qkv(rng, b, s, hq, hkv, d, dv=None):
    dv = dv or d
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,d,prefix,softcap", [
    (2, 37, 4, 2, 16, (5, 20), None),
    (2, 37, 4, 2, 16, (0, 37), 5.0),
    (1, 70, 8, 1, 32, (33,), None),
    (3, 24, 2, 2, 8, (1, 12, 30), 20.0),   # a prefix past S
])
def test_prefix_mask_plain_matches_reference(b, s, hq, hkv, d, prefix,
                                             softcap):
    """The plain version with ``prefix_len`` against the reference's
    ``attention_streamed`` prefix branch (kv blocks of 16, so S is
    ragged), rtol 1e-5, atol 1e-6; its lse is the log-sum-exp of the
    masked, softcapped scores."""
    rng = np.random.default_rng(s + hq)
    q, k, v = qkv(rng, b, s, hq, hkv, d)
    pre = np.array(prefix, np.int32)
    scale = d ** -0.5
    want = jax_layers.attention_streamed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=scale, attn_softcap=softcap, prefix_len=jnp.asarray(pre),
        kv_block=16)
    got, lse = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=scale, softcap=softcap,
        prefix_len=torch.from_numpy(pre), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # lse from the scores in float64
    g = hq // hkv
    sc = np.einsum("bskgd,btkd->bkgst",
                   q.reshape(b, s, hkv, g, d).astype(np.float64),
                   k.astype(np.float64)) * scale
    if softcap is not None:
        sc = softcap * np.tanh(sc / softcap)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (j <= i)[None] | (j[None] < pre[:, None, None])
    sc = np.where(mask[:, None, None], sc, -np.inf)
    m = sc.max(-1)
    want_lse = m + np.log(np.exp(sc - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(b, hq, s),
                               rtol=1e-5, atol=1e-5)


def test_prefix_of_zero_is_the_causal_mask():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, 2, 19, 4, 2, 8))
    zero = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(ops.flash_attention(q, k, v, prefix_len=zero),
                       ops.flash_attention(q, k, v))
    full = torch.full((2,), 19, dtype=torch.int32)
    assert torch.equal(
        fa.visible(19, causal=True, window=None, prefix_len=full),
        torch.ones(2, 19, 19, dtype=torch.bool))


def test_prefix_len_is_guarded():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in qkv(rng, 2, 9, 2, 2, 8))
    with pytest.raises(TypeError, match="prefix_len"):
        ops.flash_attention(q, k, v, prefix_len=torch.zeros(2))
    with pytest.raises(ValueError, match="prefix_len"):
        ops.flash_attention(q, k, v,
                            prefix_len=torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the VLM: reduced paligemma-3b
# ---------------------------------------------------------------------------

PROMPT, GEN = 12, 6


def vlm_prompt(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (2, PROMPT)),
            rng.standard_normal((2, cfg.n_patches, cfg.d_model))
            .astype(np.float32))


def test_paligemma_generate_matches_reference():
    """``generate`` with patches: tokens equal to the reference's, and the
    prefill's last-token logits and every teacher-forced train-mode
    logit (the prefix-LM mask over the 4 patches) within 1e-4 of the
    reference's largest."""
    jax_cfg, jax_params, cfg, params = both_models("paligemma-3b", seed=5)
    assert cfg.family == "vlm" and cfg.n_patches == 4
    toks, patches = vlm_prompt(cfg, 6)
    want = np.asarray(jax_generate(
        jax_cfg, JaxCtx(), jax_params,
        {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}, GEN))
    got = generate(cfg, ShardCtx(), params,
                   {"tokens": torch.from_numpy(toks),
                    "patches": torch.from_numpy(patches)}, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2, "degenerate greedy tokens"

    batch = {"tokens": toks, "patches": patches}
    for mode in ("prefill", "train"):
        want = jax_forward(jax_params, jax.tree.map(jnp.asarray, batch),
                           jax_cfg, JaxCtx(mode=mode))[0]
        with torch.inference_mode():
            got = forward(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg,
                          ShardCtx(mode=mode))[0]
        assert got.shape[-2 if mode == "train" else 0] == \
            (PROMPT + cfg.n_patches if mode == "train" else 2)
        assert_rel(got, want, F32_REL, f"{mode} logits")


def test_paligemma_patches_see_each_other():
    """The prefix-LM mask at work: changing the last patch moves the
    first patch's output (bidirectional prefix), changing the last token
    does not move any earlier position (causal text)."""
    _, _, cfg, params = both_models("paligemma-3b", seed=5)
    toks, patches = vlm_prompt(cfg, 7)

    def logits(t, p):
        with torch.inference_mode():
            return forward(params, {"tokens": torch.from_numpy(t),
                                    "patches": torch.from_numpy(p)}, cfg,
                           ShardCtx(mode="train"))[0]
    base = logits(toks, patches)
    p2 = patches.copy()
    p2[:, -1] += 1.0
    assert not torch.allclose(logits(toks, p2)[:, 0], base[:, 0])
    t2 = toks.copy()
    t2[:, -1] = (t2[:, -1] + 1) % cfg.vocab
    assert torch.equal(logits(t2, patches)[:, :-1], base[:, :-1])


# ---------------------------------------------------------------------------
# the encoder: reduced hubert-xlarge
# ---------------------------------------------------------------------------

def test_hubert_forward_matches_reference():
    """Frames through the frame frontend and bidirectional layers: logits
    within 1e-4 of the reference's largest; the last frame moves the
    first position's logits (no causal mask)."""
    jax_cfg, jax_params, cfg, params = both_models("hubert-xlarge", seed=8)
    assert cfg.family == "encoder" and not cfg.causal
    assert not hasattr(params, "embed") and params.frontend.shape == \
        (cfg.d_model, cfg.d_model)
    frames = np.random.default_rng(9).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    want, want_aux = jax_forward(jax_params, {"frames": jnp.asarray(frames)},
                                 jax_cfg, JaxCtx(mode="train"))
    with torch.inference_mode():
        got, aux = forward(params, {"frames": torch.from_numpy(frames)}, cfg,
                           ShardCtx(mode="train"))
        f2 = frames.copy()
        f2[:, -1] += 1.0
        moved = forward(params, {"frames": torch.from_numpy(f2)}, cfg,
                        ShardCtx(mode="train"))[0]
    assert got.shape == (2, 23, cfg.vocab)
    assert_rel(got, want, F32_REL, "encoder logits")
    assert float(aux) == float(want_aux) == 0.0
    assert not torch.allclose(moved[:, 0], got[:, 0])


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_paligemma_on_the_cpu(capsys):
    out = serve.main(["--arch", "paligemma-3b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
                      "5"])
    assert out.shape == (2, 5)
    assert "arch=paligemma-3b device=cpu" in capsys.readouterr().out


def test_serve_cli_refuses_the_frame_frontend():
    with pytest.raises(SystemExit, match="no decode step"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
