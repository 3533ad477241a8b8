"""Tensor-parallel training of the dense, encoder and VLM families on
gloo ranks, held to one device and to the reference.

* Reduced glm4-9b in float32, one step on a (2, 4) ``("data", "model")``
  mesh over 8 ranks (``tests/test_sharding.py``'s own case: q heads 4
  over 4, kv heads 2 whole, each rank taking its q head's kv head): the
  loss within 2e-4 and every parameter within atol 5e-4 / rtol 5e-3 of
  the port's one-device step and of the reference's ``jax.jit`` step.
* Reduced gemma3-4b (qk-norm, windowed layers, post-block norms) and
  hubert-xlarge (bidirectional, the frame frontend column-parallel) on
  the same mesh, heads split: logits, gradients and the step against
  one device. gemma3's step accumulates 2 microbatches (each a slice of
  every data rank's rows, as the reference pins them) against one
  device's step over 2 microbatches.
* Reduced gemma2-2b and paligemma-3b at (1, 8): their 4 heads do not
  divide 8, so ``make_ctx`` picks ``shard_map_seq`` (16 query rows cut
  into 8 chunks at their offsets); gemma2 also under ``"batch"``
  (B = 8) and ``"seq"``. Logits and one step against one device.
* The gradient invariant, on every parameter of every case: each rank's
  gradient is its slice of the one-device gradient of its data-parallel
  rows (a replicated parameter's slice is all of it); and the step's
  ``grad_norm`` equals the one-device norm.
* ``make_ctx`` / ``mesh_axes_for`` equal the reference's for every
  ``ARCHS`` config at (16, 16) and (2, 16, 16); ``shard_params`` of the
  SSM, hybrid, MoE and MLA families at (2, 4), every leaf at its spec's
  slice; glm4's ``generate`` under split heads (its 2 kv heads cut over
  the slots) equal to one device's tokens; ``train.py --mesh 2x4
  --device cpu --reduced`` for 2 steps against the one-device CLI, its
  checkpoint restored on one device.

Float32 tolerances: logits and gradients within 1e-4 of the largest
(``tests/test_torch_models.py``'s model tolerance: the same sums in
another order and over other splits), the norm within rtol 1e-5. Rank
bodies live at module level and JAX is imported inside the tests, so a
spawned rank imports torch alone; every spawn runs under a deadline.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh, mesh_coords, spawn_cpu_ranks
from repro_torch.launch.specs import input_specs, make_ctx, mesh_axes_for
from repro_torch.models import ShardCtx, forward, init_params
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime import generate
from repro_torch.runtime.train_loop import family_loss, make_train_step
from repro_torch.sharding import MeshAxes, Partitioner, shard_params
from repro_torch.sharding.partition import shard_slices

DEADLINE = 120.0
F32_REL = 1e-4
NORM_RTOL = 1e-5
# the reference parity test's own tolerances and optimizer
LOSS_ATOL, PARAM_ATOL, PARAM_RTOL = 2e-4, 5e-4, 5e-3
REF_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# the other cases: eps 1e-3 keeps each Adam step continuous in the
# gradient (test_torch_train.py's)
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


def cfg_of(name):
    return reduced(ARCHS[name]).replace(dtype="float32")


def batch_arrays(cfg, b, s, seed=11):
    batch = TokenPipeline(cfg, PipelineConfig(batch=b, seq_len=s,
                                              seed=seed)).make_batch(0)
    return {k: v.numpy() for k, v in batch.items()}


def rows_of(batch, i, n):
    """Data-parallel shard i of n of a batch of arrays or tensors."""
    b = next(iter(batch.values())).shape[0] // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def model_of(cfg, weights):
    """The port's model of ``cfg`` holding ``weights`` ({name: array})."""
    model = init_params(cfg, torch.Generator())
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(weights[k]))
    return model


def logits_and_grads(model, batch, cfg, ctx):
    """The train-mode logits of ``batch`` and the gradients of its loss
    (dense families: no aux loss), as arrays."""
    model.requires_grad_(True)
    logits, _ = forward(model, batch, cfg, ctx)
    family_loss(cfg, logits, batch).backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach().numpy(), grads


def mesh_rank(rank, runs, cli_argvs, prompt):
    """``step_rank`` of each (mesh shape, cases) of ``runs`` on its mesh
    over the same 8 ranks; on the first, the first case's tokens
    generated from this rank's rows of ``prompt`` under split heads,
    and the shapes of every parameter ``shard_params`` keeps of each of
    ``FAMILIES``; then the train CLI's ``main`` on each of ``cli_argvs``
    ({start: argv}), its history."""
    from repro_torch.launch.train import main
    out = {shape: step_rank(shape, cases) for shape, cases in runs}
    shape, cases = runs[0]
    cfg = cfg_of(cases[0][0])
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    part = Partitioner(mesh, MeshAxes())
    model = shard_params(model_of(cfg, cases[0][1]), part)
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
    b = prompt.shape[0] // shape[0]
    d = mesh_coords(mesh)["data"]
    out["decode"] = generate(cfg, ctx, model, {"tokens": torch.from_numpy(
        prompt[d * b:(d + 1) * b])}, DECODE_GEN).numpy()
    out["families"] = {}
    for name in FAMILIES:
        fam = shard_params(init_params(cfg_of(name), torch.Generator()
                                       .manual_seed(0)), part)
        out["families"][name] = (
            {k: tuple(p.shape) for k, p in fam.named_parameters()},
            fam.partitioner is part,
            [getattr(m, "caches_by_spec", False) for n, m in
             fam.named_modules() if n.split(".")[-1] == "attn"])
    out["cli"] = {start: main(argv) for start, argv in cli_argvs.items()}
    return out


def step_rank(shape, cases):
    """Per case (name, weights, batch arrays, attn claim, optimizer
    kwargs, microbatches): this rank's ``attn_mode``, logits of its data rows, its
    gradients and its parameters after one ``make_train_step``, each
    with the slices of the whole tensor it holds, the loss and the
    grad norm."""
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    axes = MeshAxes(("data",), "model")
    part = Partitioner(mesh, axes)
    at = mesh_coords(mesh)
    out = {}
    for name, weights, arrays, claim, opt_kw, accum in cases:
        cfg = cfg_of(name)
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        b = batch["labels"].shape[0]
        s = batch["frames"].shape[1] if "frames" in batch else \
            batch["tokens"].shape[1] + cfg.n_patches
        ctx = make_ctx(cfg, ShapeConfig("t", s, b, "train"), mesh, axes,
                       attn_claim=claim)
        model = model_of(cfg, weights)
        specs = part.param_specs(model)
        whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
        shard_params(model, part)
        held = {k: shard_slices(whole[k], specs[k], mesh) for k in whole}
        logits, grads = logits_and_grads(
            model, rows_of(batch, at["data"], shape[0]), cfg, ctx)
        opt = OptConfig(**opt_kw)
        state, metrics = make_train_step(cfg, opt, ctx, accum,
                                         param_specs=specs)(
            {"params": model, "opt": init_opt_state(model, opt)}, batch)
        out[name, claim] = dict(
            at=at, attn_mode=ctx.attn_mode, logits=logits,
            grads=grads, held=held, loss=float(metrics["loss"]),
            grad_norm=float(metrics["grad_norm"]),
            params={k: p.detach().numpy().copy() for k, p in
                    state["params"].named_parameters()})
    return out


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

def one_device(name, weights, arrays, n_data, opt_kw, accum=1):
    """Logits and gradients of each data shard's rows, and one step on
    the whole batch (over ``accum`` microbatches), on one device."""
    cfg = cfg_of(name)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    model = model_of(cfg, weights)
    ctx = ShardCtx()
    logits, grads = zip(*(logits_and_grads(model, rows_of(batch, i, n_data),
                                           cfg, ctx) for i in range(n_data)))
    opt = OptConfig(**opt_kw)
    state, metrics = make_train_step(cfg, opt, ctx, accum)(
        {"params": model, "opt": init_opt_state(model, opt)}, batch)
    return dict(logits=logits, grads=grads, loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                params={k: p.detach().numpy() for k, p in
                        state["params"].named_parameters()})


def close(got, want, what, rel=F32_REL):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * max(scale, 1e-30), \
        f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def check_ranks(outs, key, want, n_data, step_tol=None):
    """Every rank against one device: its logits, every gradient as its
    slice of the one-device gradient of its rows, the norm, the loss and
    the new parameters (within ``close`` or, with ``step_tol``, the
    reference parity test's tolerances)."""
    for out in outs:
        got = out[key]
        d = got["at"]["data"]
        close(got["logits"], want["logits"][d], f"{key} logits @{got['at']}")
        assert set(got["grads"]) == set(want["grads"][d])
        for k, g in got["grads"].items():
            close(g, want["grads"][d][k][got["held"][k]],
                  f"{key} grad {k} @{got['at']}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL, err_msg=f"{key} norm")
        assert abs(got["loss"] - want["loss"]) < LOSS_ATOL, key
        for k, p in got["params"].items():
            w = want["params"][k][got["held"][k]]
            if step_tol:
                np.testing.assert_allclose(p, w, atol=PARAM_ATOL,
                                           rtol=PARAM_RTOL,
                                           err_msg=f"{key} new {k}")
            else:
                close(p, w, f"{key} new {k}")


def port_weights(name, seed):
    """{name: array} of the reduced config: ``init_params`` from ``seed``
    with every vector (the norm scales) redrawn N(0, 0.1), so no norm is
    the identity."""
    gen = torch.Generator().manual_seed(seed)
    model = init_params(cfg_of(name), gen)
    return {k: (torch.randn(p.shape, generator=gen) * 0.1 if p.dim() == 1
                else p).numpy() for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

SPLIT = (2, 4)            # the reference parity test's mesh: heads split
SMALL = (1, 8)            # 4 heads do not divide 8: the axis is claimed
CLAIMED = {"auto": "shard_map_seq", "seq": "seq", "batch": "batch"}


CLI_STARTS = {"fresh": 0, "reference": 1}    # the step each run starts at
FAMILIES = ("mamba2-780m", "zamba2-7b", "qwen3-moe-235b-a22b",
            "deepseek-v2-lite-16b")
DECODE_GEN = 5


def cli_argv(root, start):
    """The train CLI's arguments for 2 steps of reduced glm4-9b from
    ``start`` (``"reference"``: the reference trainer's checkpoint at
    step 1 under ``root``), checkpointing every step into ``root``'s
    ``ckpt`` (one device) or ``mesh`` (with ``--mesh 2x4``)."""
    argv = ["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch",
            "4", "--seq", "16", "--ckpt-every", "1", "--steps",
            str(CLI_STARTS[start] + 2)]
    if start == "reference":
        argv += ["--from-reference", str(root / "ref")]
    return argv


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One spawn of 8 ranks for everything (every test of this file
    reads it, so run the file on one worker: the repo's ``-n 6 --dist
    loadfile``, or serially): on ``SPLIT`` glm4-9b (the
    reference's weights and its parity case: B 8 x 32, its optimizer),
    gemma3-4b (its step over 2 microbatches) and hubert-xlarge; on ``SMALL`` gemma2-2b (``auto``,
    ``seq``, and ``batch`` at B = 8) and paligemma-3b; decode under
    split heads; the train CLI with ``--mesh 2x4`` from each of
    ``CLI_STARTS``. Returns (every rank's results, one device's, the
    reference's glm4 step, the CLI runs' directories)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.optim.adamw import OptConfig as JaxOpt
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.runtime.train_loop import make_train_step as jax_step
    from repro_torch.models import params_from_reference
    from test_torch_models import model_configs, reference_weights
    from test_torch_train import as_port_tree
    runs, wants = [], {}
    split = []
    for name, seed, b, s, opt_kw, accum in (
            ("glm4-9b", 0, 8, 32, REF_OPT, 1), ("gemma3-4b", 1, 4, 16, OPT, 2),
            ("hubert-xlarge", 2, 4, 16, OPT, 1)):
        if name == "glm4-9b":
            jax_cfg, _ = model_configs(name)
            tree = reference_weights(jax_cfg, seed)
            weights = {k: p.detach().numpy() for k, p in
                       params_from_reference(tree, cfg_of(name))
                       .named_parameters()}
            arrays = batch_arrays(cfg_of(name), b, s)
            params = jax.tree.map(jnp.asarray, tree)
            jopt = JaxOpt(**opt_kw)
            jstate, jm = jax.jit(jax_step(jax_cfg, jopt, JaxCtx()))(
                {"params": params, "opt": jax_init_opt(params, jopt)},
                {k: jnp.asarray(v) for k, v in arrays.items()})
            ref = (float(jm["loss"]), {k: v.numpy() for k, v in as_port_tree(
                jstate["params"], cfg_of(name)).items()})
        else:
            weights = port_weights(name, seed)
            arrays = batch_arrays(cfg_of(name), b, s)
        split.append((name, weights, arrays, "auto", opt_kw, accum))
        wants[name, "auto"] = one_device(name, weights, arrays, SPLIT[0],
                                         opt_kw, accum)
    small = []
    for name, claim, b in (("gemma2-2b", "auto", 2), ("gemma2-2b", "seq", 2),
                           ("gemma2-2b", "batch", 8),
                           ("paligemma-3b", "auto", 2)):
        weights = port_weights(name, 3)
        arrays = batch_arrays(cfg_of(name), b, 16)
        small.append((name, weights, arrays, claim, OPT, 1))
        wants[name, claim] = one_device(name, weights, arrays, SMALL[0], OPT)
    runs = [(SPLIT, split), (SMALL, small)]
    from test_torch_checkpoint_convert import reference_checkpoint
    roots = {start: tmp_path_factory.mktemp(f"cli_{start}")
             for start in CLI_STARTS}
    reference_checkpoint(roots["reference"] / "ref", "glm4-9b", "float32")
    argvs = {start: cli_argv(root, start) + ["--mesh", "2x4", "--ckpt-dir",
                                             str(root / "mesh")]
             for start, root in roots.items()}
    name, weights = split[0][:2]
    prompt = np.random.default_rng(7).integers(0, cfg_of(name).vocab, (2, 8))
    wants["decode"] = generate(cfg_of(name), ShardCtx(),
                               model_of(cfg_of(name), weights),
                               {"tokens": torch.from_numpy(prompt)},
                               DECODE_GEN).numpy()
    outs = spawn_cpu_ranks(8, mesh_rank, runs, argvs, prompt,
                           timeout=DEADLINE)
    return outs, wants, ref, roots


def test_split_heads_on_2x4_equal_one_device_and_the_reference(mesh_runs):
    """glm4-9b (the reference parity test's case), gemma3-4b and
    hubert-xlarge, heads split over 4 model ranks and the batch over 2
    data ranks: logits, gradients, the norm and one step against one
    device (gemma3's over 2 microbatches); glm4's step also against the
    reference's ``jax.jit`` step."""
    outs, wants, (loss, params), _ = mesh_runs
    outs = [o[SPLIT] for o in outs]
    for name in ("glm4-9b", "gemma3-4b", "hubert-xlarge"):
        assert {o[name, "auto"]["attn_mode"] for o in outs} == {None}
        check_ranks(outs, (name, "auto"), wants[name, "auto"], SPLIT[0],
                    step_tol=name == "glm4-9b")
    for out in outs:
        got = out["glm4-9b", "auto"]
        assert abs(got["loss"] - loss) < LOSS_ATOL
        for k, p in got["params"].items():
            np.testing.assert_allclose(p, params[k][got["held"][k]],
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"glm4 vs reference {k}")


def test_small_heads_on_1x8_claim_the_model_axis(mesh_runs):
    """gemma2-2b and paligemma-3b, whose 4 heads do not divide 8:
    ``make_ctx`` picks ``shard_map_seq`` (each rank 2 query rows of 16
    at its offset, the prefix mask over paligemma's 4 patches); gemma2
    also under ``"seq"`` and, at B = 8, ``"batch"``. Every rank's logits,
    gradients and step against one device."""
    outs, wants, _, _ = mesh_runs
    outs = [o[SMALL] for o in outs]
    for name, claim in (("gemma2-2b", "auto"), ("gemma2-2b", "seq"),
                        ("gemma2-2b", "batch"), ("paligemma-3b", "auto")):
        assert {o[name, claim]["attn_mode"] for o in outs} == \
            {CLAIMED[claim]}
        check_ranks(outs, (name, claim), wants[name, claim], SMALL[0])


def test_decode_under_split_heads_equals_one_device(mesh_runs):
    """glm4-9b's ``generate`` with its q heads split over 4 model ranks
    and its 2 kv heads' cache cut over the slots (the reference's
    ``cache_spec``), each data rank on its row: one device's tokens."""
    outs, wants = mesh_runs[0], mesh_runs[1]
    for o in outs:
        d = o[SPLIT][("glm4-9b", "auto")]["at"]["data"]
        np.testing.assert_array_equal(o["decode"], wants["decode"][d:d + 1])


def test_make_ctx_and_mesh_axes_equal_the_reference(monkeypatch):
    """``attn_mode``, ``dp_axes`` and ``fsdp`` of every config at the
    production meshes, train and decode, against the reference's
    ``make_ctx`` and ``mesh_axes_for``; the input specs' shapes. (The
    reference's abstract init is traced once a config.)"""
    from types import SimpleNamespace

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.launch import specs as jax_specs
    from repro.sharding.partition import MeshAxes as JaxAxes
    from repro.sharding.partition import abstract_mesh
    from repro_torch.configs import SHAPES
    monkeypatch.setattr(jax_specs, "abstract_params",
                        functools.cache(jax_specs.abstract_params))
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        sizes = dict(zip(axes, shape))
        jmesh = abstract_mesh(shape, axes)
        jdev = SimpleNamespace(axis_names=axes,
                               devices=SimpleNamespace(shape=shape))
        for name, cfg in ARCHS.items():
            jcfg = JAX_ARCHS[name]
            port_axes = mesh_axes_for(cfg, sizes)
            ref_axes = jax_specs.mesh_axes_for(jcfg, jdev)
            assert (port_axes.data, port_axes.fsdp) == \
                (ref_axes.data, ref_axes.fsdp), name
            for sname in ("train_4k", "decode_32k"):
                for claim in ("auto", "batch", "seq", "none"):
                    got = make_ctx(cfg, SHAPES[sname], sizes, port_axes,
                                   attn_claim=claim)
                    want = jax_specs.make_ctx(
                        jcfg, JAX_SHAPES[sname], jmesh,
                        JaxAxes(ref_axes.data, "model", ref_axes.fsdp),
                        attn_claim=claim)
                    assert (got.attn_mode, got.dp_axes, got.mode) == (
                        want.attn_mode, tuple(want.dp_axes), want.mode), \
                        (name, sname, claim)
            for sname in ("train_4k", "decode_32k"):
                got = input_specs(cfg, SHAPES[sname])
                want = jax_specs.input_specs(jcfg, JAX_SHAPES[sname])
                for k in ("tokens", "labels", "frames", "patches"):
                    assert (k in got) == (k in want), (name, k)
                    if k in got:
                        assert got[k].shape == want[k].shape, (name, k)


def test_shard_params_takes_every_family(mesh_runs):
    """The SSM, hybrid, MoE and MLA families at (2, 4): every parameter
    a rank keeps has its spec's slice shape (Mamba-2's heads and
    ``d_inner``, the LoRA's ``b_*``, MLA's ``wkv_b``, the experts and
    the shared experts' F over 4), the model records its partitioner
    and every attention module (none in mamba2) decodes at
    ``cache_spec``'s layout."""
    tp = Partitioner(dict(zip(("data", "model"), SPLIT)), MeshAxes())
    for name in FAMILIES:
        model = init_params(cfg_of(name), torch.Generator(), "meta")
        specs = tp.param_specs(model)
        cut = 0
        for o in mesh_runs[0]:
            shapes, recorded, marked = o["families"][name]
            assert recorded and all(marked), name
            assert marked or cfg_of(name).family == "ssm", name
            for k, p in model.named_parameters():
                want = tuple(n // (SPLIT[1] if specs[k][i:i + 1] ==
                                   ("model",) else 1)
                             for i, n in enumerate(p.shape))
                assert shapes[k] == want, (name, k, shapes[k], want)
                cut += shapes[k] != tuple(p.shape)
        assert cut, name


@pytest.mark.parametrize("start", sorted(CLI_STARTS))
def test_train_cli_on_a_2x4_mesh_equals_one_device(mesh_runs, start):
    """``launch/train.py --mesh 2x4 --device cpu --reduced`` on 8 gloo
    ranks, 2 steps of glm4-9b, from a fresh state or (``--from-reference``)
    from the reference trainer's checkpoint at step 1, sharded on load:
    its losses equal the one-device CLI's (within 2e-4), and its
    checkpoint, written through ``shardings=``, restores on one device
    to the one-device run's parameters (within atol 5e-4 / rtol 5e-3)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main
    from repro_torch.runtime.train_loop import init_train_state
    outs, root = mesh_runs[0], mesh_runs[3][start]
    first = CLI_STARTS[start]
    one = main(cli_argv(root, start) + ["--ckpt-dir", str(root / "ckpt")])
    for out in outs:
        hist = out["cli"][start]
        assert [h["step"] for h in hist] == [h["step"] for h in one]
        for h, w in zip(hist, one):
            assert abs(h["loss"] - w["loss"]) < LOSS_ATOL, (h, w)
    cfg = cfg_of("glm4-9b")
    opt = OptConfig()
    states = []
    for d in ("mesh", "ckpt"):
        mgr = CheckpointManager(str(root / d))
        assert mgr.list_steps() == [first + 1, first + 2]
        states.append(mgr.restore_latest(init_train_state(
            cfg, opt, torch.Generator().manual_seed(9))))
    got, want = (dict(s["params"].named_parameters()) for s in states)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   w.detach().numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    assert int(states[0]["opt"]["step"]) == first + 2
