"""The port's serving runtime on the CPU: continuous batching against the
JAX package's batcher on the same weights and requests, each request
equal to ``generate`` of it alone, the cache padding, and the serve CLI
with ``--device cpu``."""

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
    jax_cfg, jax_params, cfg, params = gemma2
    want = JaxBatcher(jax_cfg, jax_params, n_slots=2, max_seq=MAX_SEQ)
    got = ContinuousBatcher(cfg, params, n_slots=2, max_seq=MAX_SEQ)
    for r in requests(cfg.vocab, JaxRequest):
        want.submit(r)
    for r in requests(cfg.vocab, Request):
        got.submit(r)
    assert got.run() == want.run()
    for rid in range(len(REQUESTS)):
        assert got.by_rid[rid].done and want.by_rid[rid].done
        assert got.by_rid[rid].out == want.by_rid[rid].out, rid
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
        assert r.done and r.out == want.by_rid[r.rid].out, r.rid
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


def test_serve_cli_runs_mamba2_on_cpu(capsys):
    before = (ops.rmsnorm.launches, ops.ssd_scan.launches)
    out = serve.main(["--device", "cpu", "--reduced", "--arch",
                      "mamba2-780m", "--batch", "2", "--prompt-len", "20",
                      "--gen", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert "arch=mamba2-780m device=cpu batch=2" in capsys.readouterr().out
    assert (ops.rmsnorm.launches, ops.ssd_scan.launches) == before
