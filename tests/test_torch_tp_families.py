"""Tensor parallelism of the SSM, hybrid, MLA and MoE families, and
decode under a mesh at the reference's cache layout, on gloo ranks, held
to one device and to the reference.

* Training, reduced mamba2-780m, zamba2-7b, deepseek-v2-lite-16b and
  qwen3-moe-235b-a22b in float32 (MoE at a capacity where nothing
  drops) under ``shard_params`` at (1, 4) and (2, 2): every rank's
  train-mode logits of its data rows, and its gradient of every leaf
  (of the cross-entropy) as its slice of the one-device gradient of its
  rows, within 1e-4 of the whole one-device leaf's largest element (a
  slice's own largest can sit at the float32 noise of a sum that
  cancels: the scan's ``A_log`` and ``dt_bias``); one
  ``make_train_step`` (aux loss in) against the port's one-device step
  and the reference's ``jax.jit`` step on the same weights: the loss
  within 2e-4, the grad norm within rtol 1e-4 (1e-3 for the MoE family:
  its aux loss under ``moe_a2a`` is the mean of each rank's chunk's, as
  the reference's ``moe_a2a`` takes it, not the whole batch's, which
  moved the norm 4e-4 at M = 4), every new parameter within atol 5e-4 /
  rtol 5e-3 (the reference parity test's tolerances).
* ``launch/train.py --arch zamba2-7b --mesh 2x2 --device cpu
  --reduced`` for 2 steps: every rank's losses within 2e-4 of the
  one-device CLI's.
* FSDP composes: reduced zamba2-7b (its shared block's weights and one
  LoRA slot gathered over the data axis in the block's call) at (2, 2)
  under ``MeshAxes(fsdp=True)``, one step against one device's within
  the parity tolerances.
* Decode: ``generate`` on the mesh gives one device's tokens, and the
  teacher-forced logits of the prefill and every decode step are within
  1e-4 of the largest of one device's and of the reference's serve step,
  for reduced mamba2 (the SSM state and ``conv_x`` over heads), zamba2
  and qwen3 (kv heads over M = 2; over the slots at M = 4), deepseek
  (MLA's latent over the slots) and gemma2-2b (window 16: its ring
  layers decoded past the window, over the slots at M = 4). Every cache
  tensor a rank holds has its :meth:`Partitioner.cache_spec` shape.
* ``flash_decode_torch`` with the log-sum-exp over slot ranges, one of
  them empty, merged by ``merge_ranges``, equals the whole cache's
  (float32 within 1e-6 of the largest output, lse within 1e-5), and
  the entry point refuses ``pos`` -1 without ``return_lse``.
* The gated norm over split ``d_inner`` and a Mamba-2 split that cuts a
  group are held apart from the rest: ``ssm_groups``' refusal.

Float32 tolerances as ``tests/test_torch_tp.py``'s (the same sums in
another order and over other splits). One spawn of 4 ranks per mesh
shape, in one module fixture; rank bodies live at module level and JAX
is imported inside the fixture, so a spawned rank imports torch alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_torch, merge_ranges
from repro_torch.launch.mesh import make_mesh, mesh_coords, spawn_cpu_ranks
from repro_torch.launch.specs import make_ctx
from repro_torch.models import ShardCtx, forward, params_from_reference
from repro_torch.models.blocks import ssm_groups
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime import make_prefill, make_serve_step, pad_cache_to
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.train_loop import family_loss, make_train_step
from repro_torch.sharding import MeshAxes, Partitioner, shard_params
from repro_torch.sharding.partition import shard_slices
from test_torch_tp import (F32_REL, LOSS_ATOL, PARAM_ATOL, PARAM_RTOL,
                           batch_arrays, close, rows_of)

DEADLINE = 150.0
SHAPES = ((1, 4), (2, 2))
TRAIN = ("mamba2-780m", "zamba2-7b", "deepseek-v2-lite-16b",
         "qwen3-moe-235b-a22b")
DECODE = ("mamba2-780m", "zamba2-7b", "deepseek-v2-lite-16b",
          "qwen3-moe-235b-a22b", "gemma2-2b")
SSM = ("mamba2-780m", "zamba2-7b")
MOE = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
B, S = 4, 16                  # training batch: B divides both data sizes
PROMPT, GEN = 12, 6           # decode: gemma2 runs past its window of 16
GEMMA_GEN = 8
NORM_RTOL = 1e-4
MOE_NORM_RTOL = 1e-3      # the aux loss of each rank's chunk, see above
# eps 1e-3 keeps each Adam step continuous in the gradient
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)


def cfg_of(name):
    """The reduced float32 config; MoE at a capacity of E / k of the even
    share, where every expert can take every token: nothing drops."""
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    return cfg


def model_of(cfg, weights):
    """The port's model of ``cfg`` holding ``weights`` ({name: array})."""
    from repro_torch.models import init_params
    model = init_params(cfg, torch.Generator())
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(weights[k]))
    return model


def ce_logits_and_grads(model, batch, cfg, ctx):
    """Train-mode logits of ``batch`` and every leaf's gradient of its
    cross-entropy (no aux loss), as arrays."""
    model.requires_grad_(True)
    logits, _ = forward(model, batch, cfg, ctx)
    family_loss(cfg, logits, batch).backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.requires_grad_(False)
    return logits.detach().numpy(), grads


def teacher_forced(model, cfg, ctx, prompt, toks, part=None):
    """The prefill's logits and each decode step's on ``toks`` (B, n):
    (n, B, V) as an array, and the caches' shapes after the last step."""
    b, s = prompt.shape
    n = toks.shape[1]
    max_seq = s + n
    if part is not None:
        max_seq = -(-max_seq // part.model_n) * part.model_n
    with torch.inference_mode():
        logits, cache = make_prefill(cfg, ctx)(model, {"tokens": prompt})
        cache = pad_cache_to(cfg, cache, b, max_seq, part)
        out = [logits]
        step = make_serve_step(cfg, ctx)
        for i in range(n - 1):
            _, logits, cache = step(model, cache, toks[:, i:i + 1], s + i)
            out.append(logits)
    return (torch.stack(out).numpy(),
            [{k: tuple(t.shape) for k, t in c.items()} for c in cache],
            max_seq)


# ---------------------------------------------------------------------------
# rank body
# ---------------------------------------------------------------------------

def step_on(cfg, weights, batch, mesh, axes):
    """One ``make_train_step`` of a model kept by ``shard_params`` under
    ``axes``: (loss, grad norm, this rank's new parameters, the slices
    of the whole it holds)."""
    part = Partitioner(mesh, axes)
    ctx = make_ctx(cfg, ShapeConfig("t", S, B, "train"), mesh, axes)
    model = model_of(cfg, weights)
    specs = part.param_specs(model)
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    shard_params(model, part)
    opt = OptConfig(**OPT)
    model.requires_grad_(True)
    state, metrics = make_train_step(cfg, opt, ctx, 1, param_specs=specs)(
        {"params": model, "opt": init_opt_state(model, opt)}, batch)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            {k: p.detach().numpy().copy() for k, p in
             state["params"].named_parameters()},
            {k: shard_slices(whole[k], specs[k], mesh) for k in whole})


def family_rank(rank, shape, train_cases, decode_cases, fsdp_cases,
                cli_argv=None):
    """On a ``shape`` ("data", "model") mesh over 4 ranks: per training
    case (name, cfg, weights, batch arrays) this rank's logits and CE
    gradients of its rows, the slices it holds, and one step; per decode
    case (name, cfg, weights, prompt, tokens to force, n to generate)
    its rows' generated tokens, teacher-forced logits and caches'
    shapes; per FSDP case (name, cfg, weights, batch arrays) one step
    under ``MeshAxes(fsdp=True)``; the train CLI's ``main`` on
    ``cli_argv`` (with its ``--mesh``), its history."""
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    axes = MeshAxes(("data",), "model")
    part = Partitioner(mesh, axes)
    at = mesh_coords(mesh)
    out = {"at": at}
    for name, cfg, weights, arrays in train_cases:
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        ctx = make_ctx(cfg, ShapeConfig("t", S, B, "train"), mesh, axes)
        model = model_of(cfg, weights)
        specs = part.param_specs(model)
        whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
        shard_params(model, part)
        held = {k: shard_slices(whole[k], specs[k], mesh) for k in whole}
        logits, grads = ce_logits_and_grads(
            model, rows_of(batch, at["data"], shape[0]), cfg, ctx)
        opt = OptConfig(**OPT)
        model.requires_grad_(True)
        state, metrics = make_train_step(cfg, opt, ctx, 1,
                                         param_specs=specs)(
            {"params": model, "opt": init_opt_state(model, opt)}, batch)
        out["train", name] = dict(
            attn_mode=ctx.attn_mode, logits=logits, grads=grads, held=held,
            loss=float(metrics["loss"]),
            grad_norm=float(metrics["grad_norm"]),
            params={k: p.detach().numpy().copy() for k, p in
                    state["params"].named_parameters()})
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
    for name, cfg, weights, prompt, toks, n_gen in decode_cases:
        bl = prompt.shape[0] // shape[0]
        rows = slice(at["data"] * bl, (at["data"] + 1) * bl)
        prompt_r = torch.from_numpy(prompt[rows])
        model = shard_params(model_of(cfg, weights), part)
        gen = generate(cfg, ctx, model, {"tokens": prompt_r}, n_gen)
        tf, shapes, max_seq = teacher_forced(
            model, cfg, ctx, prompt_r, torch.from_numpy(toks[rows]), part)
        out["decode", name] = dict(tokens=gen.numpy(), logits=tf,
                                   cache_shapes=shapes, max_seq=max_seq)
    for name, cfg, weights, arrays in fsdp_cases:
        out["fsdp", name] = step_on(
            cfg, weights, {k: torch.from_numpy(v) for k, v in arrays.items()},
            mesh, MeshAxes(("data",), "model", fsdp=True))
    if cli_argv is not None:
        from repro_torch.launch.train import main
        out["cli"] = main(cli_argv)
    return out


# ---------------------------------------------------------------------------
# one device and the reference
# ---------------------------------------------------------------------------

def reference_tree(name, cfg, seed):
    """The reference's reduced config (capacity as ``cfg``'s) and a
    NumPy weight tree: Mamba-2's A and dt init and non-zero LoRA ``b_*``
    for the SSM and hybrid families (``test_torch_ssm.ssm_weights``),
    else ``test_torch_models.reference_weights``."""
    from test_torch_models import model_configs, reference_weights
    from test_torch_ssm import ssm_weights
    jax_cfg, _ = model_configs(name)
    jax_cfg = jax_cfg.replace(capacity_factor=cfg.capacity_factor)
    draw = ssm_weights if name in SSM else reference_weights
    return jax_cfg, draw(jax_cfg, seed)


def port_arrays(tree, cfg):
    return {k: p.detach().numpy().copy() for k, p in
            params_from_reference(tree, cfg).named_parameters()}


def one_device_train(cfg, weights, arrays):
    """For each data size of ``SHAPES``, each data shard's logits and CE
    gradients; one step on the whole batch; on one device."""
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    model = model_of(cfg, weights)
    shards = {n: [ce_logits_and_grads(model, rows_of(batch, i, n), cfg,
                                      ShardCtx()) for i in range(n)]
              for n in sorted({d for d, _ in SHAPES})}
    opt = OptConfig(**OPT)
    model.requires_grad_(True)
    state, metrics = make_train_step(cfg, opt, ShardCtx(), 1)(
        {"params": model, "opt": init_opt_state(model, opt)}, batch)
    return dict(logits={n: [x[0] for x in v] for n, v in shards.items()},
                grads={n: [x[1] for x in v] for n, v in shards.items()},
                loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]),
                params={k: p.detach().numpy() for k, p in
                        state["params"].named_parameters()})


def reference_train(jax_cfg, tree, arrays, cfg):
    """The reference's one ``jax.jit`` train step on one device: (loss,
    grad norm, {port name: new parameter})."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.optim.adamw import OptConfig as JaxOpt
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.runtime.train_loop import make_train_step as jax_step
    from test_torch_train import as_port_tree
    params = jax.tree.map(jnp.asarray, tree)
    jopt = JaxOpt(**OPT)
    state, m = jax.jit(jax_step(jax_cfg, jopt, JaxCtx()))(
        {"params": params, "opt": jax_init_opt(params, jopt)},
        {k: jnp.asarray(v) for k, v in arrays.items()})
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.numpy() for k, v in as_port_tree(state["params"],
                                                   cfg).items()})


def reference_teacher_forced(jax_cfg, tree, prompt, toks):
    """The reference's prefill and serve step (``make_serve_step``) on
    ``toks``: (n, B, V)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.runtime.serve_loop import make_prefill as jax_prefill
    from repro.runtime.serve_loop import make_serve_step as jax_serve_step
    from repro.runtime.serve_loop import pad_cache_to as jax_pad
    params = jax.tree.map(jnp.asarray, tree)
    b, s = prompt.shape
    n = toks.shape[1]
    logits, cache = jax.jit(jax_prefill(jax_cfg, JaxCtx()))(
        params, {"tokens": jnp.asarray(prompt)})
    cache = jax_pad(jax_cfg, cache, b, s + n)
    step = jax.jit(jax_serve_step(jax_cfg, JaxCtx()))
    out = [np.asarray(logits)]
    for i in range(n - 1):
        _, logits, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(s + i))
        out.append(np.asarray(logits))
    return np.stack(out)


def cli_argv(root):
    """The train CLI's arguments for 2 steps of reduced zamba2-7b,
    checkpointing into ``root``."""
    return ["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--steps", "2", "--ckpt-dir",
            str(root)]


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """One spawn of 4 ranks per mesh shape (every test of this file
    reads it: the repo's ``--dist loadfile`` keeps the file on one
    worker). Returns ({shape: every rank's results}, one device's
    training, the reference's steps, the decode cases with one device's
    and the reference's answers, the one-device train CLI's history)."""
    train, one, ref = [], {}, {}
    for i, name in enumerate(TRAIN):
        cfg = cfg_of(name)
        jax_cfg, tree = reference_tree(name, cfg, seed=20 + i)
        weights = port_arrays(tree, cfg)
        arrays = batch_arrays(cfg, B, S)
        train.append((name, cfg, weights, arrays))
        one[name] = one_device_train(cfg, weights, arrays)
        ref[name] = reference_train(jax_cfg, tree, arrays, cfg)
    decode, want = [], {}
    for i, name in enumerate(DECODE):
        cfg = cfg_of(name)
        jax_cfg, tree = reference_tree(name, cfg, seed=30 + i)
        weights = port_arrays(tree, cfg)
        n_gen = GEMMA_GEN if name == "gemma2-2b" else GEN
        prompt = np.random.default_rng(40 + i).integers(
            0, cfg.vocab, (2, PROMPT))
        model = model_of(cfg, weights)
        toks = generate(cfg, ShardCtx(), model,
                        {"tokens": torch.from_numpy(prompt)}, n_gen).numpy()
        tf, _, _ = teacher_forced(model, cfg, ShardCtx(),
                                  torch.from_numpy(prompt),
                                  torch.from_numpy(toks))
        want[name] = dict(tokens=toks, logits=tf,
                          ref=reference_teacher_forced(jax_cfg, tree, prompt,
                                                       toks))
        decode.append((name, cfg, weights, prompt, toks, n_gen))
    fsdp = {(2, 2): [c for c in train if c[0] == "zamba2-7b"]}
    cli = {(2, 2): cli_argv(tmp_path_factory.mktemp("mesh")) + ["--mesh",
                                                                "2x2"]}
    outs = {shape: spawn_cpu_ranks(4, family_rank, shape, train, decode,
                                   fsdp.get(shape, []), cli.get(shape),
                                   timeout=DEADLINE)
            for shape in SHAPES}
    from repro_torch.launch.train import main
    return outs, one, ref, want, main(cli_argv(tmp_path_factory.mktemp(
        "one")))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", TRAIN)
def test_training_on_a_mesh_equals_one_device_and_the_reference(
        family_runs, name, shape):
    """Every rank's logits and every leaf's gradient slice against one
    device's (within 1e-4 of the largest), then one step against one
    device's and the reference's ``jax.jit`` step."""
    outs, want, ref = family_runs[0][shape], family_runs[1][name], \
        family_runs[2][name]
    rloss, rnorm, rparams = ref
    for out in outs:
        got, at = out["train", name], out["at"]
        d = at["data"]
        assert got["attn_mode"] is None
        close(got["logits"], want["logits"][shape[0]][d],
              f"{name} logits @{at}")
        assert set(got["grads"]) == set(want["grads"][shape[0]][d])
        for k, g in got["grads"].items():
            whole = want["grads"][shape[0]][d][k]
            err = np.abs(g - whole[got["held"][k]]).max()
            assert err <= F32_REL * np.abs(whole).max(), \
                (f"{name} grad {k} @{at}: max abs err {err:.3e} > "
                 f"{F32_REL} x {np.abs(whole).max():.3e}")
        for loss, norm, params, who in (
                (want["loss"], want["grad_norm"], want["params"], "one"),
                (rloss, rnorm, rparams, "reference")):
            assert abs(got["loss"] - loss) < LOSS_ATOL, (name, who)
            np.testing.assert_allclose(
                got["grad_norm"], norm,
                rtol=MOE_NORM_RTOL if name in MOE else NORM_RTOL,
                err_msg=f"{name} norm vs {who}")
            for k, p in got["params"].items():
                np.testing.assert_allclose(
                    p, params[k][got["held"][k]], atol=PARAM_ATOL,
                    rtol=PARAM_RTOL, err_msg=f"{name} new {k} vs {who}")


def test_fsdp_composes_with_the_hybrid_family(family_runs):
    """zamba2-7b at (2, 2) under FSDP: every matrix a rank keeps is cut
    over the data axis too (the shared block's and its LoRA slots'), and
    one step equals one device's."""
    want = family_runs[1]["zamba2-7b"]
    for out in family_runs[0][(2, 2)]:
        loss, norm, params, held = out["fsdp", "zamba2-7b"]
        assert held["shared.attn.wq"][0] != slice(0, 128)   # d over data
        assert held["shared.lora.1.a"][1] != slice(0, 128)
        assert abs(loss - want["loss"]) < LOSS_ATOL
        np.testing.assert_allclose(norm, want["grad_norm"], rtol=NORM_RTOL)
        for k, p in params.items():
            np.testing.assert_allclose(p, want["params"][k][held[k]],
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"fsdp new {k}")


def test_train_cli_trains_the_hybrid_family_on_a_mesh(family_runs):
    """``launch/train.py --arch zamba2-7b --reduced --mesh 2x2 --device
    cpu`` on 4 gloo ranks, 2 steps: every rank's losses equal the
    one-device CLI's within 2e-4."""
    one = family_runs[4]
    for out in family_runs[0][(2, 2)]:
        hist = out["cli"]
        assert [h["step"] for h in hist] == [h["step"] for h in one]
        for h, w in zip(hist, one):
            assert abs(h["loss"] - w["loss"]) < LOSS_ATOL, (h, w)


def test_tensor_parallel_weights_are_split(family_runs):
    """The layouts the tests above exercise: at M = 4 each rank holds 2
    of reduced mamba2's 8 scan heads (``A_log``), 1 of 4 MLA heads
    (``wkv_b``), a quarter of qwen3's experts and of zamba2's LoRA
    ``b_q``; the kv-head weights that do not divide (2 over 4) stay
    whole."""
    out = family_runs[0][(1, 4)][1]

    def held(name, leaf):
        return out["train", name]["held"][leaf]
    assert held("mamba2-780m", "layers.0.A_log") == (slice(2, 4),)
    assert held("mamba2-780m", "layers.0.wB")[1] == slice(0, 16)
    assert held("deepseek-v2-lite-16b", "layers.1.attn.wkv_b")[1] == \
        slice(1, 2)
    assert held("qwen3-moe-235b-a22b", "layers.0.moe.wi")[0] == slice(2, 4)
    assert held("qwen3-moe-235b-a22b", "layers.0.attn.wk")[1] == \
        slice(0, 2)
    assert held("zamba2-7b", "shared.lora.0.b_q")[1] == slice(1, 2)
    assert held("zamba2-7b", "shared.down")[1] == slice(16, 32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", DECODE)
def test_decode_on_a_mesh_equals_one_device_and_the_reference(
        family_runs, name, shape):
    """``generate`` under the meshed context gives one device's tokens
    on every rank's rows; the teacher-forced logits (prefill and each
    step) are within 1e-4 of the largest of one device's and of the
    reference serve step's; the caches lie at ``cache_spec``'s layout."""
    outs, want = family_runs[0][shape], family_runs[3][name]
    m = shape[1]
    cfg = cfg_of(name)
    for out in outs:
        got, d = out["decode", name], out["at"]["data"]
        bl = want["tokens"].shape[0] // shape[0]
        rows = slice(d * bl, (d + 1) * bl)
        np.testing.assert_array_equal(got["tokens"], want["tokens"][rows])
        close(got["logits"], want["logits"][:, rows], f"{name} logits")
        close(got["logits"], want["ref"][:, rows], f"{name} vs reference")
        t = got["max_seq"]
        for c in got["cache_shapes"]:
            if "k" in c:
                hkv = cfg.n_kv_heads
                by_heads = hkv % m == 0
                assert c["k"][1:3] == ((c["k"][1], hkv // m) if by_heads
                                       else (c["k"][1], hkv)), (name, c)
                if not by_heads:
                    assert c["k"][1] * m in (t, min(cfg.window, t)), c
            if "latent" in c:
                assert c["latent"][1] * m == t, c
            if "state" in c:
                assert c["state"][1] == cfg.ssm_heads // m
                assert c["conv_x"][2] == cfg.d_inner // m
                assert c["conv_B"][2] == cfg.ssm_ngroups * cfg.ssm_state


def test_ring_layers_decode_past_their_window(family_runs):
    """gemma2-2b's local layers hold a ring of 16 slots; the forced
    tokens reach position PROMPT + GEMMA_GEN - 2 > 16, so the ring wraps
    (over the slots at M = 4, over kv heads at M = 2)."""
    cfg = cfg_of("gemma2-2b")
    assert PROMPT + GEMMA_GEN - 2 > cfg.window
    shapes = family_runs[0][(1, 4)][0]["decode", "gemma2-2b"]["cache_shapes"]
    assert (2, 16 // 4, 2, 16) in [c["k"] for c in shapes]


def slot_ranges(t, n):
    step = t // n
    return [slice(i * step, (i + 1) * step) for i in range(n)]


@pytest.mark.parametrize("ring", [False, True])
def test_flash_decode_lse_ranges_merge_to_the_whole_cache(ring):
    """The plain ``flash_decode`` over 4 slot ranges (each with its own
    count of valid slots, -1 where none is: the last range of row 0),
    merged, equals the whole cache's output and log-sum-exp; a ring
    past its length takes its first T slots."""
    g = torch.Generator().manual_seed(0)
    b, t, hq, hkv, d = 2, 32, 8, 2, 16
    q = torch.randn(b, hq, d, generator=g)
    kc = torch.randn(b, t, hkv, d, generator=g)
    vc = torch.randn(b, t, hkv, d, generator=g)
    pos = torch.tensor([13, 40 if ring else 30], dtype=torch.int32)
    whole, lse = flash_decode_torch(q, kc, vc, pos, ring=ring, softcap=5.0,
                                    return_lse=True)
    assert torch.equal(whole, flash_decode_torch(q, kc, vc, pos, ring=ring,
                                                 softcap=5.0))
    limit = torch.clamp(pos + 1, max=t) if ring else pos + 1
    parts = []
    for sl in slot_ranges(t, 4):
        count = torch.clamp(limit - sl.start, 0, sl.stop - sl.start)
        parts.append(ops.flash_decode(
            q, kc[:, sl].contiguous(), vc[:, sl].contiguous(),
            (count - 1).to(torch.int32), softcap=5.0, return_lse=True))
    assert float(parts[3][1][0].max()) == -np.inf
    assert float(parts[3][0][0].abs().max()) == 0.0
    out, merged = merge_ranges(*zip(*parts))
    close(out.numpy(), whole.numpy(), "merged output", rel=1e-6)
    np.testing.assert_allclose(merged.numpy(), lse.numpy(), rtol=1e-5)


def test_flash_decode_takes_an_empty_range_only_with_lse():
    """``pos`` -1 is a range with no valid slot under ``return_lse``
    alone; below -1 is refused either way."""
    q, kc = torch.zeros(1, 2, 8), torch.zeros(1, 4, 2, 8)
    empty = torch.tensor([-1], dtype=torch.int32)
    with pytest.raises(IndexError, match="outside"):
        ops.flash_decode(q, kc, kc, empty)
    with pytest.raises(IndexError, match="outside"):
        ops.flash_decode(q, kc, kc, empty - 1, return_lse=True)
    out, lse = ops.flash_decode(q, kc, kc, empty, return_lse=True)
    assert float(out.abs().max()) == 0.0 and bool(torch.isinf(lse).all())


def test_ssm_groups_refuses_a_split_across_a_group():
    """Heads of a rank read whole groups, or part of one; 6 heads in 3
    groups over 2 ranks (3 heads a rank, 2 a group) are refused."""
    assert ssm_groups(48, 1, 12, 3) == (0, 1)
    assert ssm_groups(8, 4, 4, 1) == (2, 2)
    assert ssm_groups(8, 2, 2, 3) == (1, 1)
    with pytest.raises(ValueError, match="whole groups"):
        ssm_groups(6, 3, 3, 0)
