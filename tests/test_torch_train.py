"""The port's training path on the CPU, held against the JAX package.

The backward of the two kernels of the training path, through their
plain versions and through the autograd Functions of
``repro_torch.models.layers``: ``flash_attention`` against ``jax.grad``
of the reference's ``attention`` (its custom VJP ``_flash_bwd``, and
autodiff of its windowed and prefix-LM forms) and ``rmsnorm`` against
``jax.grad`` of ``rms_norm``; ``cross_entropy``; AdamW over three steps;
the data pipeline array for array; ``make_train_step``'s loss,
gradients and new parameters for the dense, VLM, encoder, MoE/MLA, SSM
and hybrid families (reduced gemma2-2b, paligemma-3b, hubert-xlarge,
deepseek-v2-lite-16b, qwen3-moe-235b-a22b, mamba2-780m, zamba2-7b), with
gradient accumulation; remat policies; the ``Trainer`` on the SSM and hybrid
families; the checkpoint manager and the ``Trainer``'s resume; the
training CLI. The ``ssd_scan`` backward itself is held to the reference
in ``test_torch_ssm_train.py``. Everything in
float32 on NumPy-made inputs; the CUDA kernels run only on the card
(``test_torch_cuda.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import layers as jax_layers
from repro.models.model import ShardCtx as JaxCtx
from repro.optim import adamw as jax_adamw
from repro.runtime import train_loop as jax_train
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import PipelineConfig, Prefetcher, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import ShardCtx, params_from_reference
from repro_torch.models.layers import attention, cross_entropy, rms_norm
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.runtime.train_loop import (Trainer, init_train_state,
                                            make_loss_fn, make_train_step)

from test_torch_models import assert_rel
from test_torch_models import both_models as dense_models
from test_torch_ssm import both_models as ssm_models

ROOT = Path(__file__).resolve().parents[1]
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
F32_REL = 1e-4


# ---------------------------------------------------------------------------
# flash_attention backward
# ---------------------------------------------------------------------------

ATTN_CASES = {   # b, s, hq, hkv, d, dv, causal, window, softcap, prefix
    "causal-gqa": (2, 37, 4, 2, 16, 16, True, None, None, None),
    "softcap": (2, 37, 4, 2, 16, 16, True, None, 5.0, None),
    "window": (2, 37, 4, 2, 16, 16, True, 8, None, None),
    "window-softcap-g8": (1, 45, 8, 1, 16, 16, True, 16, 20.0, None),
    "prefix": (2, 37, 4, 1, 16, 16, True, None, None, (5, 20)),
    "prefix-softcap": (3, 21, 2, 2, 8, 8, True, None, 3.0, (0, 7, 30)),
    "d-unequal-dv": (2, 33, 4, 4, 24, 16, True, None, None, None),
    "bidirectional-d20": (2, 29, 4, 4, 20, 20, False, None, None, None),
}


def attn_inputs(case, seed=0):
    b, s, hq, hkv, d, dv, causal, window, softcap, prefix = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, s, hq, dv)).astype(np.float32)
    pre = None if prefix is None else np.array(prefix, np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    return (q, k, v, dout, pre), kw, d ** -0.5


def reference_attention_grads(q, k, v, dout, pre, kw, scale):
    def f(q, k, v):
        out = jax_layers.attention(
            q, k, v, causal=kw["causal"], window=kw["window"], scale=scale,
            attn_softcap=kw["softcap"],
            prefix_len=None if pre is None else jnp.asarray(pre))
        return jnp.sum(out * dout)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_backward_matches_reference(case):
    """dq, dk, dv of the plain backward (fed the plain forward's out and
    lse) and of ``layers.attention`` under autograd on the CPU, against
    ``jax.grad`` of the reference's ``attention``: rtol 1e-4, atol 1e-5."""
    (q, k, v, dout, pre), kw, scale = attn_inputs(case)
    want = reference_attention_grads(q, k, v, dout, pre, kw, scale)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    tpre = None if pre is None else torch.from_numpy(pre)
    out, lse = ops.flash_attention(*t[:3], scale=scale, prefix_len=tpre,
                                   return_lse=True, **kw)
    plain = ops.flash_attention_bwd(*t[:3], out, t[3], lse, scale=scale,
                                    prefix_len=tpre, **kw)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in t[:3])
    got = attention(qg, kg, vg, causal=kw["causal"], window=kw["window"],
                    scale=scale, attn_softcap=kw["softcap"],
                    prefix_len=tpre)
    torch.testing.assert_close(got.detach(), out, rtol=0, atol=0)
    (got * t[3]).sum().backward()
    for name, w, p, a in zip("qkv", want, plain, (qg.grad, kg.grad,
                                                  vg.grad)):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=ATTN_RTOL,
                                   atol=ATTN_ATOL, err_msg=f"plain d{name}")
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=ATTN_RTOL,
                                   atol=ATTN_ATOL, err_msg=f"autograd d{name}")


def test_flash_attention_lse_matches_reference_forward():
    """The forward's lse against the reference custom VJP's residual
    (``_flash_fwd_impl``), in the reference's (B, Hkv, G, S) order."""
    (q, k, v, _, _), _, scale = attn_inputs("causal-gqa")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    kb = 64
    pad = ((0, 0), (0, kb - s), (0, 0), (0, 0))
    _, want = jax_layers._flash_fwd_impl(
        jnp.asarray(q), jnp.pad(jnp.asarray(k), pad),
        jnp.pad(jnp.asarray(v), pad), jnp.arange(s), scale, True, None, kb,
        (), s)
    _, lse = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale=scale, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(
        b, hq, s), rtol=1e-5, atol=1e-5)


def test_flash_attention_backward_is_guarded():
    (q, k, v, dout, _), _, _ = attn_inputs("causal-gqa")
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = ops.flash_attention(*t[:3], return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(*t[:3], out, t[3], lse[:, :, :-1])
    with pytest.raises(TypeError, match="dout"):
        ops.flash_attention_bwd(*t[:3], out, t[3].double(), lse)
    assert ops.flash_attention_bwd.launches == 0    # CPU: plain version


# ---------------------------------------------------------------------------
# rmsnorm backward, cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [True, False])
@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 2304), (1, 16)])
def test_rmsnorm_backward_matches_reference(zero_centered, shape):
    """dx and dscale of ``layers.rms_norm`` under autograd (the
    ``rmsnorm_bwd`` Function) and of ``ops.rmsnorm_bwd`` against
    ``jax.grad`` of the reference's ``rms_norm``: rtol 1e-5 (atol 1e-6
    for entries that cancel near zero)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(jax_layers.rms_norm(
        x, w, zero_centered=zero_centered) * dy), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(scale))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(scale).requires_grad_(True)
    (rms_norm(xt, wt, zero_centered=zero_centered)
     * torch.from_numpy(dy)).sum().backward()
    dx, dw = ops.rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(dy),
                             zero_centered=zero_centered)
    for got in ((xt.grad, wt.grad), (dx, dw)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("softcap,z_loss", [(None, 0.0), (30.0, 1e-4)])
def test_cross_entropy_matches_reference(softcap, z_loss):
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    f = lambda lg: jax_layers.cross_entropy(          # noqa: E731
        lg, jnp.asarray(labels), logit_softcap=softcap, z_loss=z_loss)
    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(lt, torch.from_numpy(labels), logit_softcap=softcap,
                        z_loss=z_loss)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "int8"])
def test_apply_updates_matches_reference_over_three_steps(compression):
    """Parameters, moments (and the error-feedback residual) after three
    steps with clipping active, rtol 1e-6."""
    rng = np.random.default_rng(4)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jcfg = jax_adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                               compression=compression)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                    compression=compression)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_adamw.init_opt_state(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = init_opt_state(tp, cfg)
    for g in grads:
        jp, jstate, jstats = jax_adamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jcfg)
        tp, state, stats = apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, state, cfg)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for part in ("m", "v") + (("ef",) if compression == "int8" else ()):
            np.testing.assert_allclose(state[part][k].numpy(),
                                       np.asarray(jstate[part][k]),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2-2b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_token_pipeline_batches_equal_the_reference(name):
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    jax_cfg, cfg = jax_reduced(JAX_ARCHS[name]), reduced(ARCHS[name])
    want = JaxTokenPipeline(jax_cfg, JaxPipelineConfig(batch=3, seq_len=20,
                                                       seed=7), start_step=2)
    got = TokenPipeline(cfg, PipelineConfig(batch=3, seq_len=20, seed=7),
                        start_step=2)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    pre = Prefetcher(TokenPipeline(cfg, PipelineConfig(batch=3, seq_len=20,
                                                       seed=7)))
    try:
        for step in range(4):
            batch = next(pre)
            for k, v in got.make_batch(step).items():
                assert torch.equal(batch[k], v)
    finally:
        pre.close()
    assert not pre.thread.is_alive()


# ---------------------------------------------------------------------------
# make_train_step against the reference
# ---------------------------------------------------------------------------

TRAIN_MODELS = ["gemma2-2b", "paligemma-3b", "hubert-xlarge",
                "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "mamba2-780m",
                "zamba2-7b"]
SSM_MODELS = ("mamba2-780m", "zamba2-7b")
SEQ = 24            # above the reduced window of 16; 3 chunks of 8


def both_models(name, seed):
    """Reference and port models on the same weights. The SSM and hybrid
    families take ``test_torch_ssm``'s draw (Mamba-2's A and dt init,
    non-zero LoRA ``b_*``, so the state carried between chunks and the
    per-slot LoRA both carry gradient)."""
    return ssm_models(name, seed) if name in SSM_MODELS \
        else dense_models(name, seed=seed)


def opt_configs():
    # eps 1e-3 keeps each Adam step continuous in the gradient (at eps
    # 1e-8 a gradient element near zero gives +-lr on its sign alone)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    return jax_adamw.OptConfig(**kw), OptConfig(**kw)


def batch_of(jax_cfg, b=2, seed=11):
    arrays = JaxTokenPipeline(jax_cfg, JaxPipelineConfig(
        batch=b, seq_len=SEQ, seed=seed)).make_batch(0)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.asarray(v)).long()
             if np.asarray(v).dtype == np.int32 else torch.from_numpy(v)
             for k, v in arrays.items()})


def as_port_tree(tree, cfg):
    """A reference-layout tree (gradients) as {port name: tensor}."""
    model = params_from_reference(jax.tree.map(np.asarray, tree), cfg)
    return {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("name", TRAIN_MODELS)
def test_train_step_matches_reference(name, grad_accum):
    """Loss and every parameter's gradient (``make_loss_fn`` +
    autograd, through the kernels' backward Functions) against
    ``jax.value_and_grad`` of the reference's ``make_loss_fn``, each
    within 1e-4 of the reference's largest; then one ``make_train_step``
    (``grad_accum`` microbatches) against the reference's: the loss, the
    aux loss and every new parameter."""
    jax_cfg, jax_params, cfg, params = both_models(name, seed=12)
    jopt, opt = opt_configs()
    jbatch, batch = batch_of(jax_cfg, b=2 * grad_accum)

    if grad_accum == 1:
        (_, (jloss, _)), jgrads = jax.value_and_grad(
            jax_train.make_loss_fn(jax_cfg, JaxCtx()), has_aux=True)(
                jax_params, jbatch)
        params.requires_grad_(True)
        total, (loss, _) = make_loss_fn(cfg, ShardCtx())(params, batch)
        total.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        want = as_port_tree(jgrads, cfg)
        got = {k: p.grad for k, p in params.named_parameters()}
        assert set(got) == set(want)
        for k in want:
            assert_rel(got[k], want[k], F32_REL, f"grad {k}")
        params.zero_grad(set_to_none=True)

    jstep = jax_train.make_train_step(jax_cfg, jopt, JaxCtx(),
                                      grad_accum=grad_accum)
    jstate, jmetrics = jstep({"params": jax_params,
                              "opt": jax_adamw.init_opt_state(jax_params,
                                                              jopt)}, jbatch)
    step = make_train_step(cfg, opt, ShardCtx(), grad_accum=grad_accum)
    state, metrics = step({"params": params,
                           "opt": init_opt_state(params, opt)}, batch)
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    want = as_port_tree(jstate["params"], cfg)
    for k, p in state["params"].named_parameters():
        assert_rel(p.detach(), want[k], F32_REL, f"new {k}")


def remat_gradients_agree(name, seed=13):
    _, _, cfg, params = both_models(name, seed=seed)
    _, batch = batch_of(cfg)
    params.requires_grad_(True)
    grads = {}
    for remat in ("full", "dots", "none"):
        c = cfg.replace(remat=remat)
        params.zero_grad(set_to_none=True)
        total, _ = make_loss_fn(c, ShardCtx())(params, batch)
        total.backward()
        grads[remat] = {k: p.grad.clone()
                        for k, p in params.named_parameters()}
    for remat in ("dots", "none"):
        for k, g in grads["full"].items():
            torch.testing.assert_close(grads[remat][k], g, rtol=1e-5,
                                       atol=1e-7)


def test_remat_policies_give_the_same_gradients():
    """``remat`` full, dots and none: the same loss and gradients (the
    recomputation repeats the forward's arithmetic)."""
    remat_gradients_agree("gemma2-2b")


@pytest.mark.parametrize("name", SSM_MODELS)
def test_remat_policies_give_the_same_gradients_ssm_and_hybrid(name):
    """The same for the SSM (each ``MambaLayer`` recomputed, its scan's
    backward from the recomputed inputs) and the hybrid (the shared
    block and its LoRA slots recomputed too)."""
    remat_gradients_agree(name)


@pytest.mark.parametrize("name", SSM_MODELS)
def test_remat_recomputes_the_scan_forward_once_per_layer(name, monkeypatch):
    """Under ``remat="full"`` each Mamba layer's scan runs forward twice
    (the forward and its recomputation) and backward once; under
    ``"none"`` once each."""
    _, _, cfg, params = both_models(name, seed=14)
    _, batch = batch_of(cfg)
    params.requires_grad_(True)
    n_mamba = sum(k == "ssm" for k in cfg.layer_kinds())
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.ssd_scan, ops.ssd_scan_bwd

    def counted(key, fn):
        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(ops, "ssd_scan", counted("fwd", fwd))
    monkeypatch.setattr(ops, "ssd_scan_bwd", counted("bwd", bwd))
    for remat, want in (("full", 2), ("none", 1)):
        counts.update(fwd=0, bwd=0)
        total, _ = make_loss_fn(cfg.replace(remat=remat), ShardCtx())(
            params, batch)
        total.backward()
        assert counts == {"fwd": want * n_mamba, "bwd": n_mamba}, remat
        params.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", SSM_MODELS)
def test_trainer_trains_the_ssm_and_hybrid_families(name, tmp_path):
    """The SSM and hybrid families train: ``init_train_state`` from a
    generator and two ``Trainer`` steps on one repeated batch, finite
    losses, the second below the first, every parameter moved and a
    checkpoint committed at the end."""
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    before = {k: p.detach().clone()
              for k, p in state["params"].named_parameters()}

    class Repeat:                   # the same batch at every step
        def __init__(self):
            self.batch = TokenPipeline(cfg, PipelineConfig(
                batch=2, seq_len=SEQ, seed=5)).make_batch(0)

        def __iter__(self):
            return self

        def __next__(self):
            return self.batch
    state, hist, _ = Trainer(cfg, opt, ShardCtx(), str(tmp_path),
                             ckpt_every=10).run(state, Repeat(), 2,
                                                log_every=1)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[1] < losses[0], losses
    moved = [k for k, p in state["params"].named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) == len(before)
    assert CheckpointManager(str(tmp_path)).list_steps() == [2]


# ---------------------------------------------------------------------------
# checkpoints and the Trainer
# ---------------------------------------------------------------------------

def small_cfg(dtype="float32"):
    return reduced(ARCHS["gemma2-2b"]).replace(dtype=dtype)


def fresh_state(cfg, seed, opt=OptConfig(warmup_steps=1, total_steps=6)):
    return init_train_state(cfg, opt, torch.Generator().manual_seed(seed))


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    """Four steps in one run; two steps with a checkpoint, a fresh state
    (other random weights) restored from it, and two more: the same loss
    at steps 3-4 and the same parameters and moments, bit for bit."""
    cfg = small_cfg()
    opt = OptConfig(warmup_steps=1, total_steps=6)
    pcfg = PipelineConfig(batch=2, seq_len=SEQ, seed=3)
    ctx = ShardCtx()

    full, hist_full, _ = Trainer(cfg, opt, ctx, str(tmp_path / "a"),
                                 ckpt_every=2).run(
        fresh_state(cfg, 0, opt), TokenPipeline(cfg, pcfg), 4, log_every=1)
    Trainer(cfg, opt, ctx, str(tmp_path / "b"), ckpt_every=2).run(
        fresh_state(cfg, 0, opt), TokenPipeline(cfg, pcfg), 2, log_every=1)
    mgr = CheckpointManager(str(tmp_path / "b"))
    assert mgr.list_steps() == [2]
    state = mgr.restore_latest(fresh_state(cfg, 99, opt))
    assert int(state["opt"]["step"]) == 2
    resumed, hist, _ = Trainer(cfg, opt, ctx, str(tmp_path / "b"),
                               ckpt_every=2).run(
        state, TokenPipeline(cfg, pcfg, start_step=2), 4, log_every=1)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_full[2:]]
    for (k, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), k
    for part in ("m", "v"):
        for k, a in full["opt"][part].items():
            assert torch.equal(a, resumed["opt"][part][k]), (part, k)
    assert mgr.list_steps() == [2, 4]


def test_checkpoint_keeps_bf16_bits_ignores_uncommitted_and_keeps_k(tmp_path):
    cfg = small_cfg("bfloat16")
    state = fresh_state(cfg, 1)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(state, step)
    mgr.wait()
    assert mgr.list_steps() == [2, 3]
    # a partial save: no COMMIT marker, or still under its .tmp name
    os.makedirs(tmp_path / "step_00000009")
    (tmp_path / "step_00000009" / "state.npz").write_bytes(b"partial")
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert mgr.list_steps() == [2, 3]
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["step"] == 3 and meta["dtypes"]["params/embed"] == "bfloat16"
    other = mgr.restore_latest(fresh_state(cfg, 2))
    for (k, a), (_, b) in zip(state["params"].named_parameters(),
                              other["params"].named_parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.int16), b.view(torch.int16)), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_latest(state)


def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "demo-20m", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout
    assert CheckpointManager(str(tmp_path)).list_steps() == [3]
