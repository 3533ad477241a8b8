"""The port's serving runtime on the CPU: continuous batching against the
JAX package's batcher on the same weights and requests (dense K/V, MLA
latent, Mamba-2 conv/state caches), each request equal to ``generate``
of it alone, the cache padding, and the serve CLI with ``--device
cpu``."""

import numpy as np
import pytest
import torch

from repro.runtime.batching import ContinuousBatcher as JaxBatcher
from repro.runtime.batching import Request as JaxRequest
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ShardCtx, init_cache, init_params
from repro_torch.runtime import (ContinuousBatcher, Request, generate,
                                 pad_cache_to)

from test_torch_models import both_models, model_configs

# ragged prompts (some past the reduced window of 16), ragged budgets
REQUESTS = [(9, 5), (40, 3), (23, 6), (40, 4), (17, 1)]
MAX_SEQ = 64


def requests(vocab, cls):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(REQUESTS)]


@pytest.fixture(scope="module")
def gemma2():
    return both_models("gemma2-2b", seed=9)


def test_batcher_matches_reference_batcher(gemma2):
    """Every request's tokens and the tick count against the reference's
    batcher. The reference emits one token more than ``max_new`` when
    ``max_new`` is 1 (it decodes once after the prefill's token), so each
    request is held to the reference's first ``max_new`` tokens."""
    jax_cfg, jax_params, cfg, params = gemma2
    want = JaxBatcher(jax_cfg, jax_params, n_slots=2, max_seq=MAX_SEQ)
    got = ContinuousBatcher(cfg, params, n_slots=2, max_seq=MAX_SEQ)
    for r in requests(cfg.vocab, JaxRequest):
        want.submit(r)
    for r in requests(cfg.vocab, Request):
        got.submit(r)
    assert got.run() == want.run()
    for rid, (_, max_new) in enumerate(REQUESTS):
        assert got.by_rid[rid].done and want.by_rid[rid].done
        assert len(got.by_rid[rid].out) == max_new, rid
        assert got.by_rid[rid].out == want.by_rid[rid].out[:max_new], rid
    assert len({t for r in got.by_rid.values() for t in r.out}) > 3


def test_each_batched_request_equals_generate_alone(gemma2):
    """A slot runs the same computation as ``generate`` of its request
    alone at batch 1 with the batcher's ``max_seq``."""
    _, _, cfg, params = gemma2
    batcher = ContinuousBatcher(cfg, params, n_slots=3, max_seq=MAX_SEQ)
    reqs = requests(cfg.vocab, Request)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for r in reqs:
        alone = generate(cfg, ShardCtx(), params,
                         {"tokens": torch.from_numpy(r.prompt[None]).long()},
                         len(r.out), max_seq=MAX_SEQ)
        assert alone[0].tolist() == r.out, r.rid


def alone(cfg, params, prompt, n):
    return generate(cfg, ShardCtx(), params,
                    {"tokens": torch.from_numpy(prompt[None]).long()}, n,
                    max_seq=MAX_SEQ)[0].tolist()


@pytest.mark.parametrize("max_new", [1, 2, 3])
def test_batcher_emits_max_new_tokens_or_stops_at_eos(gemma2, max_new):
    """Each request emits exactly ``max_new`` tokens, ``generate(n_tokens=
    max_new)`` of it alone; with ``eos_id`` the first request's prefill
    token, every request stops at its first EOS, that one at its join."""
    _, _, cfg, params = gemma2
    prompts = [r.prompt for r in requests(cfg.vocab, Request)]
    want = [alone(cfg, params, p, max_new) for p in prompts]
    eos = want[0][0]
    for eos_id in (None, eos):
        batcher = ContinuousBatcher(cfg, params, n_slots=2, max_seq=MAX_SEQ,
                                    eos_id=eos_id)
        for rid, p in enumerate(prompts):
            batcher.submit(Request(rid=rid, prompt=p, max_new=max_new))
        batcher.run()
        for rid, w in enumerate(want):
            if eos_id is not None and eos_id in w:
                w = w[:w.index(eos_id) + 1]
            assert batcher.by_rid[rid].done
            assert batcher.by_rid[rid].out == w, (eos_id, rid)
    assert batcher.by_rid[0].out == [eos]


def test_reference_batcher_emits_two_tokens_for_max_new_one(gemma2):
    """The reference's batcher decodes once after the prefill's token, so
    a request of ``max_new`` 1 gets two tokens there (the port emits
    one); its first is the port's."""
    jax_cfg, jax_params, cfg, params = gemma2
    prompt = requests(cfg.vocab, Request)[0].prompt
    ref = JaxBatcher(jax_cfg, jax_params, n_slots=1, max_seq=MAX_SEQ)
    ref.submit(JaxRequest(rid=0, prompt=prompt, max_new=1))
    ref.run()
    port = ContinuousBatcher(cfg, params, n_slots=1, max_seq=MAX_SEQ)
    port.submit(Request(rid=0, prompt=prompt, max_new=1))
    port.run()
    assert len(ref.by_rid[0].out) == 2 and len(port.by_rid[0].out) == 1
    assert port.by_rid[0].out == ref.by_rid[0].out[:1]


def test_pad_cache_to_grows_only_the_sequence_axis():
    _, cfg = model_configs("gemma2-2b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    from repro_torch.models import forward
    for s in (10, 40):          # under and over the local window (16)
        toks = torch.zeros((2, s), dtype=torch.long)
        _, _, cache = forward(params, {"tokens": toks}, cfg,
                              ShardCtx(mode="prefill"))
        padded = pad_cache_to(cfg, cache, 2, 50)
        for layer, c, p, z in zip(cfg.layer_kinds(), cache, padded,
                                  init_cache(cfg, 2, 50)):
            t = min(cfg.window, 50) if layer.endswith("local") else 50
            assert p["k"].shape == z["k"].shape == (2, t, cfg.n_kv_heads,
                                                    cfg.head_dim)
            filled = min(s, c["k"].shape[1])
            assert torch.equal(p["k"][:, :filled], c["k"][:, :filled])
            assert not p["v"][:, filled:].any()


def test_serve_cli_runs_on_cpu(capsys):
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    out = serve.main(["--device", "cpu", "--reduced", "--arch", "gemma2-2b",
                      "--batch", "2", "--prompt-len", "20", "--gen", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert (0 <= out).all() and (out < model_configs("gemma2-2b")[1].vocab
                                 ).all()
    text = capsys.readouterr().out
    assert "arch=gemma2-2b device=cpu batch=2" in text
    assert (ops.rmsnorm.launches, ops.flash_attention.launches,
            ops.flash_decode.launches) == counts


def test_resolve_config_matches_reference():
    from repro.launch.train import resolve_config as jax_resolve
    for name, red in (("demo-20m", False), ("gemma2-2b", True),
                      ("glm4-9b", False)):
        got, want = serve.resolve_config(name, red), jax_resolve(name, red)
        assert repr(got) == repr(want)


def test_configs_are_copies_of_the_reference():
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import cells as jax_cells
    from repro_torch.configs import ARCHS, SHAPES, cells, reduced
    from repro.configs import reduced as jax_reduced
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert repr(ARCHS[name]) == repr(JAX_ARCHS[name])
        assert repr(reduced(ARCHS[name])) == repr(jax_reduced(JAX_ARCHS[name]))
        assert ARCHS[name].layer_kinds() == JAX_ARCHS[name].layer_kinds()
    assert {k: repr(v) for k, v in SHAPES.items()} == \
        {k: repr(v) for k, v in JAX_SHAPES.items()}
    assert cells() == jax_cells()


# ---------------------------------------------------------------------------
# the SSM and hybrid families: Mamba-2 conv/state caches, Zamba-2's
# shared-block K/V caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_batcher_with_ssm_caches_matches_reference_batcher(name):
    """Per-slot caches holding conv tails and SSM states (and, for
    zamba2, the shared block's K/V): the port's batcher gives the
    reference batcher's tokens for every request, and each request
    equals ``generate`` of it alone. The prompts (9-40 tokens) are
    ragged against the reduced chunk of 8."""
    from test_torch_ssm import both_models as ssm_models
    jax_cfg, jax_params, cfg, params = ssm_models(name, seed=21)
    want = JaxBatcher(jax_cfg, jax_params, n_slots=2, max_seq=MAX_SEQ)
    got = ContinuousBatcher(cfg, params, n_slots=2, max_seq=MAX_SEQ)
    for r in requests(cfg.vocab, JaxRequest):
        want.submit(r)
    reqs = requests(cfg.vocab, Request)
    for r in reqs:
        got.submit(r)
    assert got.run() == want.run()
    for r in reqs:
        # the reference's batcher emits two tokens for max_new 1
        assert len(r.out) == r.max_new, r.rid
        assert r.done and r.out == want.by_rid[r.rid].out[:r.max_new], r.rid
        alone = generate(cfg, ShardCtx(), params,
                         {"tokens": torch.from_numpy(r.prompt[None]).long()},
                         len(r.out), max_seq=MAX_SEQ)
        assert alone[0].tolist() == r.out, r.rid
    assert len({t for r in reqs for t in r.out}) > 3


@pytest.mark.parametrize("s", [2, 21])     # under and over the conv width
def test_pad_cache_to_leaves_conv_tails_and_states_alone(s):
    """zamba2 reduced: the shared block's K/V grow along the sequence
    axis only (zeros past the prompt); every Mamba layer's conv tails
    and state come back as the very tensors the prefill made."""
    from repro_torch.models import block_plan, forward
    from test_torch_ssm import model_configs as ssm_configs
    _, cfg = ssm_configs("zamba2-7b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, s), dtype=torch.long)
    _, _, cache = forward(params, {"tokens": toks}, cfg,
                          ShardCtx(mode="prefill"))
    padded = pad_cache_to(cfg, cache, 2, 50)
    for (what, _), c, p, z in zip(block_plan(cfg), cache, padded,
                                  init_cache(cfg, 2, 50)):
        assert sorted(p) == sorted(z)
        assert all(p[k].shape == z[k].shape for k in z)
        if what == "shared":
            assert torch.equal(p["k"][:, :s], c["k"])
            assert not p["v"][:, s:].any()
        else:
            assert all(p[k] is c[k] for k in c)
            assert c["conv_x"].shape[1] == cfg.ssm_conv - 1


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_batcher_with_moe_and_mla_caches_matches_reference_batcher(name):
    """Per-slot MLA caches (latent and ``k_rope``, padded to ``max_seq``
    at each join) for deepseek, GQA K/V caches with qk-norm for qwen3,
    MoE layers in both: the port's batcher gives the reference batcher's
    tokens for every request, and each request equals ``generate`` of it
    alone."""
    jax_cfg, jax_params, cfg, params = both_models(name, seed=21)
    want = JaxBatcher(jax_cfg, jax_params, n_slots=2, max_seq=MAX_SEQ)
    got = ContinuousBatcher(cfg, params, n_slots=2, max_seq=MAX_SEQ)
    for r in requests(cfg.vocab, JaxRequest):
        want.submit(r)
    reqs = requests(cfg.vocab, Request)
    for r in reqs:
        got.submit(r)
    assert got.run() == want.run()
    for r in reqs:
        # the reference's batcher emits two tokens for max_new 1
        assert len(r.out) == r.max_new, r.rid
        assert r.done and r.out == want.by_rid[r.rid].out[:r.max_new], r.rid
        alone = generate(cfg, ShardCtx(), params,
                         {"tokens": torch.from_numpy(r.prompt[None]).long()},
                         len(r.out), max_seq=MAX_SEQ)
        assert alone[0].tolist() == r.out, r.rid
    assert len({t for r in reqs for t in r.out}) > 3
    if cfg.kv_lora_rank:
        assert all(sorted(c) == ["k_rope", "latent"]
                   and c["latent"].shape == (1, MAX_SEQ, cfg.kv_lora_rank)
                   for slot in got.caches for c in slot)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_serve_cli_runs_moe_on_cpu(capsys, name):
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    out = serve.main(["--device", "cpu", "--reduced", "--arch", name,
                      "--batch", "2", "--prompt-len", "20", "--gen", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert f"arch={name} device=cpu batch=2" in capsys.readouterr().out
    assert (ops.rmsnorm.launches, ops.flash_attention.launches,
            ops.flash_decode.launches) == counts


def test_serve_cli_runs_mamba2_on_cpu(capsys):
    before = (ops.rmsnorm.launches, ops.ssd_scan.launches)
    out = serve.main(["--device", "cpu", "--reduced", "--arch",
                      "mamba2-780m", "--batch", "2", "--prompt-len", "20",
                      "--gen", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert "arch=mamba2-780m device=cpu batch=2" in capsys.readouterr().out
    assert (ops.rmsnorm.launches, ops.ssd_scan.launches) == before
