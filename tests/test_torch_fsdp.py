"""FSDP and ZeRO-1 training on gloo ranks, held to one device and to the
reference.

* Reduced glm4-9b in float32 at (2, 4) under ``MeshAxes(fsdp=True)``,
  the reference parity case (B 8 x 32, its optimizer): every parameter
  a rank holds is its slice by the whole spec (data dims halved), the
  moments at their ZeRO-1 specs; each rank's gradient from one forward
  and backward is its slice of the sum over the data ranks of the
  one-device gradients of their rows (an FSDP weight's, reduce-scattered
  by the gather's backward) or of its own rows' (a weight whole over
  data); one step within 2e-4 (loss) and atol 5e-4 / rtol 5e-3 (every
  parameter) of the port's one-device step and the reference's
  ``jax.jit`` step, the norm within rtol 1e-5.
* Reduced gemma2-2b at (8, 1), pure FSDP: B = 8 (one row a rank) and
  B = 4 (the batch does not divide 8, every rank runs all rows, and the
  FSDP gradient is still divided by 8); each step against one device.
  The layer gathers run inside the remat region: twice a layer weight
  under ``remat="full"`` and ``"dots"`` (again in the backward's
  recomputation), once under ``"none"``; the top-level ones once.
* ZeRO-1 alone at (2, 4) (``fsdp=False``): the moments at their slices,
  the step against one device.
* int8 compression, exact: ``apply_updates`` twice on hand-made slices
  of seeded whole gradients at (2, 4), under FSDP and under ZeRO-1
  alone, with the clip at 1: new parameters, ``m``, ``v`` and ``ef``
  bit for bit one device's slices; a scale taken per slice differs.
* int8, end to end: two steps of the glm4 case under FSDP against one
  device's int8 steps; the state saved through ``state_shardings``
  restores on one device within the parity tolerances and into a fresh
  sharded state on the same ranks bit for bit.
* MoE: reduced qwen3-moe's experts under ``shard_experts`` with FSDP,
  the ``a2a`` dispatch at a capacity where nothing drops, at (2, 4): one
  step against the same mesh without FSDP.
* The train CLI, ``--mesh 2x4 --device cpu --reduced --compression
  int8`` with FSDP on (``specs.FSDP_BYTES = 0`` in the rank), 2 steps of
  glm4-9b fresh and from the reference trainer's int8 checkpoint,
  against the one-device CLI with int8; its checkpoint restored on one
  device.

Float32 tolerances as ``tests/test_torch_tp.py``'s. One spawn of 8 ranks
serves every test; rank bodies live at module level and JAX is imported
inside the fixture, so a spawned rank imports torch alone.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeConfig
from repro_torch.launch.mesh import make_mesh, mesh_coords, spawn_cpu_ranks
from repro_torch.launch.specs import make_ctx
from repro_torch.models import ShardCtx
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.runtime.train_loop import (init_train_state, make_loss_fn,
                                            make_train_step, state_shardings)
from repro_torch.sharding import MeshAxes, Partitioner, Spec, shard
from repro_torch.sharding.partition import shard_experts, shard_slices
from test_torch_tp import (LOSS_ATOL, NORM_RTOL, OPT, PARAM_ATOL, PARAM_RTOL,
                           REF_OPT, batch_arrays, cfg_of, close, model_of,
                           one_device, port_weights)

DEADLINE = 150.0
SPLIT, PURE = (2, 4), (8, 1)
INT8 = dict(REF_OPT, compression="int8")
EXACT = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1e9,
             compression="int8")          # the clip is 1: no norm read
LAYOUTS = {"fsdp": MeshAxes(fsdp=True), "zero1": MeshAxes()}


def tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def expert_specs(model, part):
    """``{name: Spec}`` of a MoE model's parameters as ``shard_experts``
    keeps them: each expert weight at its spec, every other whole."""
    return {k: part.param_spec(k, tuple(p.shape))
            if k.endswith(("moe.wi", "moe.wo")) else Spec(*([None] * p.dim()))
            for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def build(mesh, name, weights, axes, opt, experts=False, remat=None):
    """A state of ``name`` holding ``weights`` cut to this rank's slices
    under ``axes`` (its parameters by their specs, or with ``experts``
    by ``shard_experts``; the moments and ``ef`` at their ZeRO-1 specs):
    (state, param specs, moment specs, the whole shapes)."""
    from repro_torch.launch.train import shard_state
    cfg = cfg_of(name) if remat is None else cfg_of(name).replace(
        remat=remat)
    part = Partitioner(mesh, axes)
    model = model_of(cfg, weights)
    model.requires_grad_(True)
    state = {"params": model, "opt": init_opt_state(model, opt)}
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    if not experts:
        specs, moments = shard_state(state, part)
        return state, specs, moments, whole
    specs = expert_specs(model, part)
    moments = part.moment_specs(model, specs)
    shard_experts(model, part)
    for key in ("m", "v"):
        state["opt"][key] = {k: shard(t, moments[k], mesh)
                             for k, t in state["opt"][key].items()}
    return state, specs, moments, whole


def run_steps(mesh, name, weights, batches, axes, opt_kw, *, grads=False,
              experts=False, capacity=None, remat=None, ckpt=None):
    """Steps of ``make_train_step`` on ``batches`` (arrays) from
    ``weights`` under ``axes``: the losses and norms, the slices of the
    whole parameters held (``held``), the local shapes, this rank's
    parameters after the steps; with ``grads`` (or ``remat``) its
    gradients of one forward and backward of the first batch before
    them and the number of FSDP gathers that ran in it; with ``ckpt`` (a
    directory) the state saved there through ``state_shardings``,
    restored into a fresh sharded state and compared bit for bit."""
    from repro_torch.sharding import collectives
    opt = OptConfig(**opt_kw)
    state, specs, moments, whole = build(mesh, name, weights, axes, opt,
                                         experts, remat)
    model = state["params"]
    cfg = model.cfg
    if capacity is not None:
        cfg = model.cfg = cfg.replace(capacity_factor=capacity)
    first = tensors(batches[0])
    b, s = first["labels"].shape
    ctx = make_ctx(cfg, ShapeConfig("t", s, b, "train"), mesh, axes)
    out = dict(at=mesh_coords(mesh), fsdp=dict(model.fsdp_dims),
               dp_axes=ctx.dp_axes,
               held={k: shard_slices(whole[k], specs[k], mesh)
                     for k in whole},
               shapes={k: tuple(p.shape) for k, p in
                       model.named_parameters()},
               moment_shapes={k: tuple(t.shape) for k, t in
                              state["opt"]["m"].items()})
    if grads or remat is not None:
        rows = {k: shard(x, Spec(ctx.dp_axes), mesh) if ctx.dp_axes else x
                for k, x in first.items()}
        calls = [0]
        real = collectives._gather_dim

        def counted(*args):
            calls[0] += 1
            return real(*args)
        collectives._gather_dim = counted
        try:
            total, _ = make_loss_fn(cfg, ctx)(model, rows)
            total.backward()
        finally:
            collectives._gather_dim = real
        out["gathers"] = calls[0]
        out["grads"] = {k: p.grad.numpy().copy()
                        for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    step = make_train_step(cfg, opt, ctx, 1, specs, moments)
    out["losses"], out["norms"] = [], []
    for arrays in batches:
        state, metrics = step(state, tensors(arrays))
        out["losses"].append(float(metrics["loss"]))
        out["norms"].append(float(metrics["grad_norm"]))
    out["params"] = {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()}
    if ckpt is not None:
        shardings = state_shardings(mesh, specs, moments)
        mgr = CheckpointManager(ckpt)
        mgr.save(state, len(batches), block=True, shardings=shardings)
        torch.distributed.barrier()
        fresh, *_ = build(mesh, name, weights, axes, opt)
        fresh = mgr.restore_latest(fresh, shardings)
        leaves = [(dict(s["params"].named_parameters()),
                   *(s["opt"][k] for k in ("m", "v", "ef")),
                   {"step": s["opt"]["step"]}) for s in (state, fresh)]
        out["restored_equal"] = all(
            torch.equal(a[k], b[k]) for a, b in zip(*leaves) for k in a)
    return out


def int8_exact(mesh, layout, seed):
    """Two ``apply_updates`` with int8 compression on this rank's slices
    of seeded whole glm4 parameters and gradients under ``layout``,
    against the same two on the whole tensors here and on the slices
    with a scale taken per slice: {what: names bit for bit its slice}."""
    part = Partitioner(mesh, LAYOUTS[layout])
    opt = OptConfig(**EXACT)
    rng = np.random.default_rng(seed)
    whole = {k: torch.from_numpy(rng.standard_normal(w.shape).astype(
        np.float32)) for k, w in port_weights("glm4-9b", seed).items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)) * (1 + i) for k, p in whole.items()} for i in range(2)]
    specs = part.param_specs(whole)
    moments = part.moment_specs(whole, specs)
    one = {k: p.clone() for k, p in whole.items()}
    one_state = init_opt_state(one, opt)
    mine = {k: shard(p, specs[k], mesh) for k, p in whole.items()}
    per_slice = {k: p.clone() for k, p in mine.items()}
    state = init_opt_state({k: shard(p, moments[k], mesh)
                            for k, p in whole.items()}, opt)
    slice_state = init_opt_state(mine, opt)
    for g in grads:
        apply_updates(one, g, one_state, opt)
        local = {k: shard(x, specs[k], mesh) for k, x in g.items()}
        apply_updates(mine, local, state, opt, specs, mesh, moments)
        apply_updates(per_slice, local, slice_state, opt)

    def equal(got, want, spec):
        return sorted(k for k in want if torch.equal(
            got[k], shard(want[k], spec[k], mesh)))
    out = {"params": equal(mine, one, specs),
           "per_slice_params": equal(per_slice, one, specs),
           "per_slice_ef": equal(slice_state["ef"], one_state["ef"], specs),
           "names": sorted(whole),
           "cut": sorted(k for k in whole if moments[k] != specs[k])}
    for key in ("m", "v", "ef"):
        out[key] = equal(state[key], one_state[key], moments)
    return out


def cli_rank(argvs):
    """The train CLI's ``main`` on each of ``argvs`` ({start: argv}) with
    FSDP forced on: {start: (history, what rank 0 printed)}."""
    from repro_torch.launch import specs
    from repro_torch.launch.train import main
    specs.FSDP_BYTES = 0
    out = {}
    for start, argv in argvs.items():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            hist = main(argv)
        out[start] = hist, text.getvalue()
    return out


def fsdp_rank(rank, cases, ckpt_dir, argvs):
    """Every case of the module on the same 8 ranks."""
    split = make_mesh(SPLIT, ("data", "model"), device_type="cpu")
    pure = make_mesh(PURE, ("data", "model"), device_type="cpu")
    fsdp = MeshAxes(fsdp=True)
    glm, glm2, gem8, gem4, qwen = (cases[k] for k in (
        "glm4", "glm4 int8", "gemma2 b8", "gemma2 b4", "qwen3"))
    out = {
        "parity": run_steps(split, "glm4-9b", glm[0], glm[1][:1], fsdp,
                            REF_OPT, grads=True),
        "zero1": run_steps(split, "glm4-9b", glm[0], glm[1][:1],
                           MeshAxes(), REF_OPT),
        "int8": run_steps(split, "glm4-9b", glm2[0], glm2[1], fsdp, INT8,
                          ckpt=ckpt_dir),
        "moe fsdp": run_steps(split, "qwen3-moe-235b-a22b", qwen[0],
                              qwen[1], fsdp, OPT, experts=True,
                              capacity=8.0),
        "moe": run_steps(split, "qwen3-moe-235b-a22b", qwen[0], qwen[1],
                         MeshAxes(), OPT, experts=True, capacity=8.0),
        "exact": {layout: int8_exact(split, layout, 5) for layout in LAYOUTS},
    }
    for remat in ("full", "dots", "none"):
        out["gemma2 b8", remat] = run_steps(pure, "gemma2-2b", gem8[0],
                                            gem8[1], fsdp, OPT, remat=remat)
    out["gemma2 b4"] = run_steps(pure, "gemma2-2b", gem4[0], gem4[1], fsdp,
                                 OPT)
    for key in ("moe fsdp", "moe"):          # whole, to compare layouts
        from repro_torch.sharding import gather
        got = out[key]
        model = model_of(cfg_of("qwen3-moe-235b-a22b"), qwen[0])
        part = Partitioner(split, LAYOUTS["fsdp" if key == "moe fsdp"
                                          else "zero1"])
        specs = expert_specs(model, part)
        got["whole"] = {k: gather(torch.from_numpy(p), specs[k],
                                  split).numpy()
                        for k, p in got["params"].items()}
    out["cli"] = cli_rank(argvs)
    return out


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

def one_device_steps(name, weights, batches, opt_kw, capacity=None):
    """(losses, parameters) of steps on one device."""
    cfg = cfg_of(name)
    if capacity is not None:
        cfg = cfg.replace(capacity_factor=capacity)
    model = model_of(cfg, weights)
    opt = OptConfig(**opt_kw)
    state = {"params": model, "opt": init_opt_state(model, opt)}
    step = make_train_step(cfg, opt, ShardCtx())
    losses, norms = [], []
    for arrays in batches:
        state, metrics = step(state, tensors(arrays))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, {k: p.detach().numpy() for k, p in
                           state["params"].named_parameters()}


CLI_STARTS = {"fresh": 0, "reference": 1}    # the step each run starts at


def cli_argv(root, start, *extra):
    """The train CLI's arguments for 2 int8 steps of reduced glm4-9b from
    ``start`` (``"reference"``: the reference trainer's int8 checkpoint
    at step 1 under ``root``), checkpointing every step."""
    argv = ["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--batch",
            "4", "--seq", "16", "--ckpt-every", "1", "--steps",
            str(CLI_STARTS[start] + 2), "--compression", "int8", *extra]
    if start == "reference":
        argv += ["--from-reference", str(root / "ref")]
    return argv


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """One spawn of 8 ranks for every test of this file (run the file on
    one worker: the repo's ``-n 6 --dist loadfile``, or serially), one
    device's runs of each case, the reference's ``jax.jit`` step of the
    parity case, and the directories the ranks wrote."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.optim.adamw import OptConfig as JaxOpt
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.runtime.train_loop import make_train_step as jax_step
    from repro_torch.models import params_from_reference
    from test_torch_models import model_configs, reference_weights
    from test_torch_train import as_port_tree

    jax_cfg, _ = model_configs("glm4-9b")
    tree = reference_weights(jax_cfg, 0)
    glm = {k: p.detach().numpy() for k, p in params_from_reference(
        tree, cfg_of("glm4-9b")).named_parameters()}
    glm_batch = batch_arrays(cfg_of("glm4-9b"), 8, 32)
    params = jax.tree.map(jnp.asarray, tree)
    jopt = JaxOpt(**REF_OPT)
    jstate, jm = jax.jit(jax_step(jax_cfg, jopt, JaxCtx()))(
        {"params": params, "opt": jax_init_opt(params, jopt)},
        {k: jnp.asarray(v) for k, v in glm_batch.items()})
    ref = (float(jm["loss"]), {k: v.numpy() for k, v in as_port_tree(
        jstate["params"], cfg_of("glm4-9b")).items()})
    gem = port_weights("gemma2-2b", 3)
    qwen = port_weights("qwen3-moe-235b-a22b", 4)
    cases = {
        "glm4": (glm, [glm_batch]),
        "glm4 int8": (glm, [batch_arrays(cfg_of("glm4-9b"), 8, 32, seed=s)
                            for s in (11, 12)]),
        "gemma2 b8": (gem, [batch_arrays(cfg_of("gemma2-2b"), 8, 16)]),
        "gemma2 b4": (gem, [batch_arrays(cfg_of("gemma2-2b"), 4, 16)]),
        "qwen3": (qwen, [batch_arrays(cfg_of("qwen3-moe-235b-a22b"), 4,
                                      16)]),
    }
    wants = {
        "parity": one_device("glm4-9b", glm, glm_batch, SPLIT[0], REF_OPT),
        "int8": one_device_steps("glm4-9b", *cases["glm4 int8"], INT8),
        "gemma2 b8": one_device_steps("gemma2-2b", *cases["gemma2 b8"], OPT),
        "gemma2 b4": one_device_steps("gemma2-2b", *cases["gemma2 b4"], OPT),
    }
    from test_torch_checkpoint_convert import reference_checkpoint
    root = tmp_path_factory.mktemp("fsdp")
    reference_checkpoint(root / "ref", "glm4-9b", "float32", "int8")
    argvs = {start: cli_argv(root, start, "--mesh", "2x4", "--ckpt-dir",
                             str(root / f"cli_{start}"))
             for start in CLI_STARTS}
    outs = spawn_cpu_ranks(8, fsdp_rank, cases, str(root / "int8"), argvs,
                           timeout=DEADLINE)
    return outs, wants, ref, cases, root


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def check_step(outs, key, want, norm=True):
    """Every rank's first loss (within ``LOSS_ATOL``), grad norm and new
    parameter slices (within ``close``) against one device's."""
    losses, norms, params = want
    for out in outs:
        got = out[key]
        assert abs(got["losses"][0] - losses[0]) < LOSS_ATOL, key
        if norm:
            np.testing.assert_allclose(got["norms"][0], norms[0],
                                       rtol=NORM_RTOL, err_msg=key)
        for k, p in got["params"].items():
            close(p, params[k][got["held"][k]], f"{key} new {k} @"
                  f"{got['at']}")


def test_fsdp_zero1_glm4_on_2x4_equals_one_device_and_the_reference(
        fsdp_runs):
    """The parity case under FSDP + ZeRO-1: the shapes each rank holds,
    its gradients before the step, and the step against one device and
    the reference's ``jax.jit`` step."""
    outs, wants, (ref_loss, ref_params), _, _ = fsdp_runs
    want = wants["parity"]
    for out in outs:
        got = out["parity"]
        whole = {k: p.shape for k, p in want["params"].items()}
        assert got["dp_axes"] == ("data",)
        assert got["fsdp"], "no parameter is cut over data"
        for k, shape in whole.items():
            spec_data = k in got["fsdp"]
            assert got["shapes"][k] == tuple(
                len(range(*sl.indices(n))) for sl, n in
                zip(got["held"][k], shape)), k
            if spec_data:
                dim = got["fsdp"][k][0]
                assert got["shapes"][k][dim] * SPLIT[0] == shape[dim], k
            assert got["moment_shapes"][k] == got["shapes"][k], k
        d = got["at"]["data"]
        for k, g in got["grads"].items():
            if k in got["fsdp"]:
                w = sum(want["grads"][i][k] for i in range(SPLIT[0]))
            else:
                w = want["grads"][d][k]
            close(g, w[got["held"][k]], f"grad {k} @{got['at']}")
        np.testing.assert_allclose(got["norms"][0], want["grad_norm"],
                                   rtol=NORM_RTOL)
        for loss in (want["loss"], ref_loss):
            assert abs(got["losses"][0] - loss) < LOSS_ATOL
        for params in (want["params"], ref_params):
            for k, p in got["params"].items():
                np.testing.assert_allclose(
                    p, params[k][got["held"][k]], atol=PARAM_ATOL,
                    rtol=PARAM_RTOL, err_msg=f"new {k} @{got['at']}")


@pytest.mark.parametrize("batch", [8, 4])
def test_pure_fsdp_gemma2_on_8x1_equals_one_device(fsdp_runs, batch):
    """gemma2-2b with every weight cut 8 ways over data: at B = 8 one row
    a rank, at B = 4 (which does not divide 8) every rank all rows and
    the reduce-scattered gradient still divided by 8."""
    outs, wants, *_ = fsdp_runs
    key = ("gemma2 b8", "full") if batch == 8 else "gemma2 b4"
    assert {o[key]["dp_axes"] for o in outs} == \
        {("data",) if batch == 8 else ()}
    check_step(outs, key, wants[f"gemma2 b{batch}"])


def test_fsdp_gathers_run_inside_the_remat_region(fsdp_runs):
    """A layer's weights are gathered again in the backward's
    recomputation under ``remat="full"`` and ``"dots"`` (so none is held
    from the forward to the backward), once under ``"none"``; the
    embedding once a forward. Each policy's step equals one device's."""
    outs, wants, *_ = fsdp_runs
    for out in outs:
        fsdp = out["gemma2 b8", "full"]["fsdp"]
        top = sum("." not in k for k in fsdp)
        layer = len(fsdp) - top
        assert top == 1 and layer > 0, fsdp      # the tied embedding
        for remat, times in (("full", 2), ("dots", 2), ("none", 1)):
            assert out["gemma2 b8", remat]["gathers"] == top + times * layer
    for remat in ("dots", "none"):
        check_step(outs, ("gemma2 b8", remat), wants["gemma2 b8"])


def test_zero1_alone_on_2x4_equals_one_device(fsdp_runs):
    """Without FSDP the parameters keep their tensor-parallel slices and
    the moments are cut over data on their first free dim: each rank
    updates its slice and all-gathers it."""
    outs, wants, *_ = fsdp_runs
    want = wants["parity"]
    for out in outs:
        got = out["zero1"]
        assert not got["fsdp"]
        finer = [k for k in got["shapes"]
                 if got["moment_shapes"][k] != got["shapes"][k]]
        assert finer, "no moment is cut finer than its parameter"
        for k in finer:
            assert np.prod(got["moment_shapes"][k]) * SPLIT[0] == \
                np.prod(got["shapes"][k]), k
        np.testing.assert_allclose(got["norms"][0], want["grad_norm"],
                                   rtol=NORM_RTOL)
        assert abs(got["losses"][0] - want["loss"]) < LOSS_ATOL
        for k, p in got["params"].items():
            close(p, want["params"][k][got["held"][k]], f"zero1 new {k}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_int8_of_sharded_gradients_is_bit_for_bit(fsdp_runs, layout):
    """int8 compression of slices takes the whole tensor's scale (an
    all-reduce MAX): two steps' parameters, moments and residuals are bit
    for bit one device's slices; a scale taken per slice is not."""
    outs = fsdp_runs[0]
    for out in outs:
        got = out["exact"][layout]
        for key in ("params", "m", "v", "ef"):
            assert got[key] == got["names"], (layout, key)
        assert bool(got["cut"]) == (layout == "zero1")
        assert got["per_slice_ef"] != got["names"]
        assert got["per_slice_params"] != got["names"]


def test_int8_fsdp_steps_and_their_checkpoint(fsdp_runs):
    """Two int8 steps of the glm4 case under FSDP against one device's;
    the saved state restores on one device within the parity tolerances
    and on the same ranks bit for bit."""
    outs, wants, _, cases, root = fsdp_runs
    losses, _, params = wants["int8"]
    for out in outs:
        got = out["int8"]
        assert got["restored_equal"]
        for g, w in zip(got["losses"], losses, strict=True):
            assert abs(g - w) < LOSS_ATOL, (got["losses"], losses)
    cfg = cfg_of("glm4-9b")
    state = CheckpointManager(str(root / "int8")).restore_latest(
        init_train_state(cfg, OptConfig(**INT8),
                         torch.Generator().manual_seed(9)))
    assert int(state["opt"]["step"]) == 2
    for k, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[k],
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)


def test_moe_experts_under_fsdp_equal_the_mesh_without(fsdp_runs):
    """qwen3-moe's experts cut over model and data, gathered in their
    layer before the ``a2a`` dispatch: the step equals the same mesh's
    without FSDP."""
    outs = fsdp_runs[0]
    for out in outs:
        got, want = out["moe fsdp"], out["moe"]
        assert {k.rsplit(".", 1)[1] for k in got["fsdp"]} == {"wi", "wo"}
        assert not want["fsdp"]
        assert abs(got["losses"][0] - want["losses"][0]) < LOSS_ATOL
        np.testing.assert_allclose(got["norms"][0], want["norms"][0],
                                   rtol=NORM_RTOL)
        for k, w in want["whole"].items():
            close(got["whole"][k], w, f"moe new {k}")


@pytest.mark.parametrize("start", sorted(CLI_STARTS))
def test_train_cli_int8_fsdp_on_a_2x4_mesh_equals_one_device(fsdp_runs,
                                                             start):
    """``launch/train.py --mesh 2x4 --compression int8`` with FSDP on,
    from a fresh state or (``--from-reference``) from the reference
    trainer's int8 checkpoint at step 1, cut to the new layout on load:
    rank 0's first line names the layout, the losses equal the one-device
    CLI's with int8, and its checkpoint restores on one device to that
    run's parameters."""
    from repro_torch.launch.train import main
    outs, _, _, _, root = fsdp_runs
    one = main(cli_argv(root, start, "--ckpt-dir", str(root / f"one_{start}")))
    first = outs[0]["cli"][start][1].splitlines()[0]
    assert "fsdp=True" in first and "moments=params" in first, first
    assert all(not o["cli"][start][1] for o in outs[1:])
    for out in outs:
        hist = out["cli"][start][0]
        assert [h["step"] for h in hist] == [h["step"] for h in one]
        for h, w in zip(hist, one):
            assert abs(h["loss"] - w["loss"]) < LOSS_ATOL, (h, w)
    cfg = cfg_of("glm4-9b")
    opt = OptConfig(compression="int8")
    states = []
    for d in (f"cli_{start}", f"one_{start}"):
        mgr = CheckpointManager(str(root / d))
        assert mgr.list_steps() == [CLI_STARTS[start] + 1,
                                    CLI_STARTS[start] + 2]
        states.append(mgr.restore_latest(init_train_state(
            cfg, opt, torch.Generator().manual_seed(9))))
    got, want = (dict(s["params"].named_parameters()) for s in states)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   w.detach().numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


def test_split_spec_and_moment_specs():
    """``split_spec`` parts a spec into its data dims and the rest and
    refuses a dim split over data and model alike; ``moment_specs`` is
    ``zero1_spec`` of each parameter at data above 1, the parameters'
    specs at one data rank."""
    from repro_torch.models import init_params
    from repro_torch.sharding.partition import split_spec
    data = ("pod", "data")
    assert split_spec(Spec(("pod", "data"), "model"), data) == \
        ({0: ("pod", "data")}, Spec(None, "model"))
    assert split_spec(Spec(None, "model"), data) == ({}, Spec(None, "model"))
    with pytest.raises(ValueError, match="alike"):
        split_spec(Spec(("data", "model")), data)
    model = init_params(cfg_of("glm4-9b"), torch.Generator().manual_seed(0),
                        "meta")
    for sizes, axes in (({"data": 2, "model": 4}, MeshAxes()),
                        ({"data": 2, "model": 4}, MeshAxes(fsdp=True)),
                        ({"data": 1, "model": 4}, MeshAxes())):
        part = Partitioner(sizes, axes)
        specs = part.param_specs(model)
        moments = part.moment_specs(model, specs)
        for k, p in model.named_parameters():
            want = specs[k] if sizes["data"] == 1 else \
                part.zero1_spec(specs[k], tuple(p.shape))
            assert moments[k] == want, (k, sizes, axes)
