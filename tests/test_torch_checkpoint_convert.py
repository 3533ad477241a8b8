"""A checkpoint written by the JAX package's trainer, read into the port
(``repro_torch.checkpoint.state_from_reference``).

Each reference state is made here: the reference's ``init_train_state``
on a reduced config, one ``make_train_step`` (so the moments, the step
and the int8 error feedback are not zero) and its
``CheckpointManager.save(block=True)`` into a temporary directory. In
bfloat16 under int8 compression the port's parameters equal the
reference's bit for bit (the bf16 leaves come back from ``np.load`` as
2-byte void) and ``m``, ``v``, ``ef`` and ``step`` exactly; in float32
the port's next ``make_train_step`` equals the reference's next step at
``test_torch_train``'s gate; the train CLI resumes at the reference's
step; a missing or extra leaf, a wrong shape or element size and a step
without ``COMMIT`` are refused with the leaf's key.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models.model import ShardCtx as JaxCtx
from repro.optim import adamw as jax_adamw
from repro.runtime import train_loop as jax_train
from repro_torch.checkpoint import (CheckpointManager,
                                    ReferenceCheckpointError,
                                    state_from_reference)
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import train as train_cli
from repro_torch.models import ShardCtx, params_from_reference
from repro_torch.optim import OptConfig
from repro_torch.runtime.train_loop import make_train_step

from test_torch_models import assert_rel
from test_torch_train import F32_REL, batch_of

MODELS = ["deepseek-v2-lite-16b", "zamba2-7b"]   # MoE/MLA; hybrid + LoRA
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


def reference_checkpoint(directory, name, dtype, compression="none",
                         steps=1, seed=0):
    """The reference's reduced ``name`` in ``dtype``: ``init_train_state``,
    ``steps`` of its ``make_train_step``, saved at that step into
    ``directory``. Returns (reference config, its state, its jitted step,
    the port's config and optimizer config)."""
    jax_cfg = jax_reduced(JAX_ARCHS[name]).replace(dtype=dtype)
    jopt = jax_adamw.OptConfig(compression=compression, **OPT)
    state = jax_train.init_train_state(jax_cfg, jopt,
                                       jax.random.PRNGKey(seed))
    step = jax.jit(jax_train.make_train_step(jax_cfg, jopt, JaxCtx()))
    for i in range(steps):
        state, _ = step(state, batch_of(jax_cfg, seed=11 + i)[0])
    JaxCheckpointManager(str(directory)).save(state, steps, block=True)
    return (jax_cfg, state, step, reduced(ARCHS[name]).replace(dtype=dtype),
            OptConfig(compression=compression, **OPT))


def port_tree(tree, cfg):
    """A reference-layout tree as {port name: tensor} (bf16 leaves
    reinterpreted from ml_dtypes' bfloat16)."""
    model = params_from_reference(jax.tree.map(np.asarray, tree), cfg)
    return {k: p.detach() for k, p in model.named_parameters()}


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("name", MODELS)
def test_bf16_int8_state_converts_bit_for_bit(name, tmp_path):
    _, jstate, _, cfg, opt = reference_checkpoint(
        tmp_path, name, "bfloat16", compression="int8")
    state = state_from_reference(str(tmp_path), cfg, opt, "cpu")
    want = port_tree(jstate["params"], cfg)
    got = dict(state["params"].named_parameters())
    assert set(got) == set(want)
    assert any(p.dtype == torch.bfloat16 for p in got.values())
    for k, p in got.items():
        assert p.dtype == want[k].dtype and p.requires_grad, k
        assert torch.equal(bits(p.detach()), bits(want[k])), k
    assert sorted(state["opt"]) == ["ef", "m", "step", "v"]
    for part in ("m", "v", "ef"):
        ref = port_tree(jstate["opt"][part], cfg)
        assert set(state["opt"][part]) == set(want)
        assert any(bool(t.any()) for t in ref.values()), part
        for k, t in state["opt"][part].items():
            assert t.dtype == torch.float32 and torch.equal(t, ref[k]), \
                (part, k)
    step = state["opt"]["step"]
    assert step.dtype == torch.int32 and step.shape == () and int(step) == 1


@pytest.mark.parametrize("name", MODELS)
def test_float32_state_takes_the_references_next_step(name, tmp_path):
    """The converted state's next ``make_train_step`` against the
    reference's from the state it saved: loss, aux loss, gradient norm
    and learning rate within 1e-4; every new parameter and moment within
    1e-4 of the reference's largest."""
    jax_cfg, jstate, jstep, cfg, opt = reference_checkpoint(
        tmp_path, name, "float32")
    state = state_from_reference(str(tmp_path / "step_00000001"), cfg, opt,
                                 "cpu")
    jbatch, batch = batch_of(jax_cfg, seed=20)
    jstate, jmetrics = jstep(jstate, jbatch)
    state, metrics = make_train_step(cfg, opt, ShardCtx())(state, batch)
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
    want = port_tree(jstate["params"], cfg)
    for k, p in state["params"].named_parameters():
        assert_rel(p.detach(), want[k], F32_REL, f"new {k}")
    for part in ("m", "v"):
        ref = port_tree(jstate["opt"][part], cfg)
        for k, t in state["opt"][part].items():
            assert_rel(t, ref[k], F32_REL, f"{part} {k}")


def test_train_cli_resumes_at_the_references_step(tmp_path, capsys):
    """``--from-reference`` starts at the reference's step 2 and runs to
    ``--steps`` 4, checkpointing in the port's format; the same command
    with that port checkpoint in ``--ckpt-dir`` is refused."""
    name = "deepseek-v2-lite-16b"
    ref, ckpt = tmp_path / "ref", tmp_path / "port"
    reference_checkpoint(ref, name, "float32", steps=2)
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt),
            "--from-reference", str(ref)]
    history = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "resumed from the reference's step 2" in out
    assert history[-1]["step"] == 4 and np.isfinite(history[-1]["loss"])
    mgr = CheckpointManager(str(ckpt))
    assert mgr.list_steps() == [4]
    meta = (ckpt / "step_00000004" / "meta.json").read_text()
    assert '"dtypes"' in meta                       # the port's format
    with pytest.raises(SystemExit, match="already holds"):
        train_cli.main(argv)


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory):
    directory = tmp_path_factory.mktemp("reference")
    *_, cfg, opt = reference_checkpoint(directory, "deepseek-v2-lite-16b",
                                        "bfloat16")
    return directory / "step_00000001", cfg, opt


def rewrite(src, dst, edit):
    """A copy of the step ``src`` at ``dst`` whose leaves ``edit`` changed
    (a dict of NumPy arrays, edited in place)."""
    shutil.copytree(src, dst)
    with np.load(src / "state.npz") as data:
        leaves = {k: data[k] for k in data.files}
    edit(leaves)
    np.savez(dst / "state.npz", **leaves)


WI = "params/groups/0/moe/wi"
REFUSALS = {
    "missing leaf": (lambda d: d.pop(WI), WI),
    "extra leaf": (lambda d: d.update({"opt/ef/embed": np.zeros(
        d["opt/m/embed"].shape, np.float32)}), "opt/ef/embed"),
    "wrong shape": (lambda d: d.update({WI: d[WI][..., :16]}), WI),
    "wrong element size": (lambda d: d.update({"params/embed": np.zeros(
        d["params/embed"].shape, np.float32)}), "params/embed"),
}


@pytest.mark.parametrize("case", list(REFUSALS) + ["no COMMIT"])
def test_refuses_what_the_port_cannot_take(case, bf16_checkpoint, tmp_path):
    src, cfg, opt = bf16_checkpoint
    dst = tmp_path / "step_00000001"
    if case == "no COMMIT":
        shutil.copytree(src, dst)
        os.remove(dst / "COMMIT")
        for path, match in ((dst, "no COMMIT"),
                            (tmp_path, "no committed checkpoint")):
            with pytest.raises(ReferenceCheckpointError, match=match):
                state_from_reference(str(path), cfg, opt, "cpu")
        return
    edit, key = REFUSALS[case]
    rewrite(src, dst, edit)
    with pytest.raises(ReferenceCheckpointError, match=key):
        state_from_reference(str(dst), cfg, opt, "cpu")
