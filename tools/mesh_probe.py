"""Run the port's expert-parallel MoE dispatch, GPipe pipeline,
tensor-parallel and FSDP training steps across the GPUs of one host,
one process a GPU on NCCL, held to one GPU's answer and timed.

    python3 tools/mesh_probe.py [--gpus N]
        [--cases moe,pipeline,tp,fsdp,families,autoplace]

``chip_smoke.py`` runs these paths on a one-rank group; this probe
gives them N ranks, so the all-to-alls, shifts and psums cross GPUs.
Every rank builds its model from seed 0 on its own GPU, so each holds
the same weights. Cases:

- ``moe``: one deepseek-v2-lite-16b MoE layer (d 2048, 64 experts top-6
  of 1408) in bf16 under a (1, N) ``("data", "model")`` mesh, its
  experts sharded N ways (``shard_experts``), on B = 2 x 1,024 tokens.
  ``moe_a2a``'s output with the capacity raised so nothing drops, and
  ``moe_local_decode``'s on 64 one-token rows, against ``moe_dense`` of
  the whole layer on the same rank, within 2e-2 of the largest output
  (bf16 products in another order). Then the forward and backward at
  the config's capacity 1.25, and the dense dispatch of the whole layer
  on one GPU beside it: CUDA-event ms, median of ``REPS`` readings,
  with the share of copies dropped.
- ``pipeline``: glm4-9b whole in bf16 (40 layers of one kind) through
  ``make_pipelined_forward`` on an (N,) ``("pod",)`` mesh, N stages, 8
  microbatches of 1 x 1,024 tokens: the logits against the
  per-microbatch ``forward`` (every rank also runs it on its whole
  model), and the gradient of mean(logits²) of each rank's own stage
  layers, embedding, final norm and head against the per-microbatch
  forward's: how many are bit for bit and the largest difference over
  its largest gradient. ms of the pipelined forward and backward (host
  clock after a synchronise, after a warm-up) a microbatch.
- ``tp``: gemma2-2b whole in bf16 on a (1, N) ``("data", "model")``
  mesh (heads 8/4 over N = 4: 2 q heads and 1 kv head a rank; F and the
  vocabulary over N), through ``mesh_axes_for``, ``make_ctx``,
  ``shard_params`` and ``make_train_step(param_specs=)``, against one
  GPU's (every rank runs it on its whole model) on the same batch of
  B = 2 x 1,024 tokens. The gradients of one forward and backward of
  the train loss, before any step: each rank's gradient of every
  parameter against its slice of the one-GPU gradient, per leaf, its
  cosine at least ``TP_GRAD_COS`` and its norm within ``TP_GRAD_NORM``
  of the one-GPU slice's (two bf16 runs whose sums split over N ranks
  differ by rounding, which moves neither; a slice taken from the wrong
  rows, a zero, a flipped sign or a sum taken twice moves one of them
  far past its gate), with the largest difference over the slice's
  largest element beside them. Then one step (AdamW at lr 1e-3, no
  warm-up): its loss within ``TP_LOSS_ATOL``, its grad norm within
  ``TP_NORM_RTOL``, and every element of the rank's parameter slices
  within 2 lr + 2 bf16 ulps of the one-GPU step's. That last bound
  checks the update, not the gradient: at step 1 Adam moves an element
  by lr times a factor in [-1, 1] whatever its gradient, so it catches
  only a move past that (a wrong rate or weight decay, a corrupted
  store) and passes any gradient. Then ``TP_TIMED`` more steps each way, ms by
  the host clock after a synchronise.

- ``fsdp``: FSDP with ZeRO-1 (ROADMAP A13b3). gemma2-2b whole in bf16
  on an (N, 1) mesh, B = N x 1,024 (one row a rank), against one GPU on
  the same batch over 2 microbatches (``grad_accum=2``, so it fits);
  glm4-9b whole on (N / 2, 2), B = N / 2 x 1,024, against (1, N)
  without FSDP (at one data rank there is nothing to cut over data).
  Both meshes take their axes from ``mesh_axes_for``, which turns FSDP
  on (the tensor-parallel weights pass 4 GB a GPU): each layer's
  weights gathered over the data ranks in its remat region, the
  gradients reduce-scattered, the moments at their ZeRO-1 specs. The
  checks of ``tp`` on the gradients the step applies (``make_grad_fn``,
  before any step) and on the parameters after one step, each leaf
  gathered whole one at a time on every rank; the loss and norm gates
  too. Numbers: median step ms of ``TP_TIMED`` timed steps and peak GB
  a GPU, beside the comparison run's.

- ``autoplace``: AMTHA's stage placement round trip (ROADMAP A13f).
  glm4-9b whole in bf16 (40 repeat units, so N stages at N = 4; gemma2-
  2b's 13 units split only into 1) placed by ``autoplace.place_pipeline``
  (the ``engine`` scheduler) on ``h100_node(1, N)``; the plan's
  assignment through ``autoplace.stage_mesh`` into
  ``make_pipelined_forward``, ``PIPE_RUN``'s microbatches forward only,
  beside the identity assignment, and a reversed one where the plan is
  the identity (on one uniform node every injection predicts the same
  makespan, so the plan is the identity and this case checks the round
  trip through a permuted mesh, not a gain). Each assignment's logits
  against the per-microbatch ``forward`` of the same GPU's whole model,
  bit for bit as the ``pipeline`` case's; ms a microbatch (CUDA events
  on rank 0 after a barrier, the median of ``AUTOPLACE_REPS``).

Prints one JSON line per case (rank 0's; for ``tp`` and ``fsdp`` also
every rank's check) and, last, the card's name and power limit. Exits
non-zero when a check fails: an output off the dense dispatch's by more
than 2e-2 of its largest, pipelined logits not bit for bit (an
``autoplace`` assignment's too), or a ``tp``
gradient or step past its gates (an ``fsdp`` run likewise, or one
without FSDP). The same dispatches, pipeline and steps run on gloo CPU
ranks in ``tests/test_torch_moe_ep.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_tp.py`` and ``tests/test_torch_fsdp.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

REPS = 10
MOE_ARCH, PIPE_ARCH = "deepseek-v2-lite-16b", "glm4-9b"
MOE_TOKENS = (2, 1024)
PIPE_RUN = dict(n_micro=8, bm=1, seq=1024)
BF16_REL = 2e-2
TP_ARCH, TP_RUN, TP_TIMED = "gemma2-2b", dict(batch=2, seq=1024), 3
TP_OPT = dict(lr=1e-3, warmup_steps=1)
TP_LOSS_ATOL = 1e-2       # bf16 sums split over N ranks, 26 layers
TP_NORM_RTOL = 2e-2
TP_GRAD_COS = 0.99        # per leaf, against the one-GPU slice
TP_GRAD_NORM = 5e-2       # per leaf, relative
# fsdp: (arch, mesh, the comparison: "one" GPU over 2 microbatches, or a
# mesh without FSDP); B = one row a data rank, 1,024 tokens
FSDP_SEQ = 1024
ZAMBA_CUT = 39            # zamba2-7b's layers one GPU trains (PERF.md §4)
F32_COS = 1e-5           # float32 on the mesh against one GPU: 1 - cosine
F32_NORM = 1e-3           # and |norm ratio - 1|, every leaf
SERVE_RUN = dict(batch=2, prompt=1024, gen=8)
SERVE_REL = 5e-2          # chip_smoke.LOGIT_REL: bf16 logits, 5e-2 of max


def median(xs):
    return sorted(xs)[len(xs) // 2]


def cfg_of(name):
    from repro_torch.configs import ARCHS
    return ARCHS[name].replace(dtype="bfloat16")


def timed(fn):
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def moe_case(rank, n, dev):
    import torch

    from chip_smoke import recorded_drops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_params, moe
    from repro_torch.sharding import MeshAxes, Partitioner, shard_experts
    cfg = cfg_of(MOE_ARCH)
    cfg = cfg.replace(n_layers=2)               # the dense layer and one MoE
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = init_params(cfg, gen, dev).layers[1].moe
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    mesh = make_mesh((1, n), ("data", "model"))
    shard_experts(model, Partitioner(mesh, MeshAxes()))
    p = model.layers[1].moe
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
    x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, activation=cfg.activation,
              n_experts=cfg.n_experts, mesh=mesh, dp_axes=("data",),
              ep_axis="model")
    out = {"case": "moe", "ranks": n, "arch": cfg.name,
           "tokens": list(MOE_TOKENS), "experts_a_rank": p.wi.shape[0]}
    with torch.no_grad():
        want, _ = moe.moe_dense(x, whole.router, whole.wi, whole.wo,
                                cfg.top_k, cfg.activation)
        y, _ = moe.moe_a2a(x, p.router, p.wi, p.wo, capacity_factor=float(
            cfg.n_experts), **kw)
        out["a2a_err"] = float((y.float() - want.float()).abs().max()) \
            / float(want.float().abs().max())
        xd = torch.randn((64, 1, cfg.d_model), generator=gen, device=dev) \
            .to(torch.bfloat16)
        want_d, _ = moe.moe_dense(xd, whole.router, whole.wi, whole.wo,
                                  cfg.top_k, cfg.activation)
        y_d, _ = moe.moe_local_decode(xd, p.router, p.wi, p.wo, **kw)
        out["local_err"] = float((y_d.float() - want_d.float()).abs().max()) \
            / float(want_d.float().abs().max())

    c = torch.randn(x.shape, generator=gen, device=dev)
    x.requires_grad_(True)
    for w in (p.router, p.wi, p.wo, whole.router, whole.wi, whole.wo):
        w.requires_grad_(True)

    def step(layer, c_ctx):
        y, aux = moe.moe_ffn(x, layer, cfg, c_ctx)
        ((y.float() * c).sum() + aux).backward()
        for w in (x, layer.router, layer.wi, layer.wo):
            w.grad = None
    with recorded_drops() as drops:
        step(p, ctx)
    step(whole, None)
    a2a = [timed(lambda: step(p, ctx)) for _ in range(REPS)]
    dense = [timed(lambda: step(whole, None)) for _ in range(REPS)]
    out.update(a2a_ms=a2a, dense_one_gpu_ms=dense,
               a2a_ms_median=median(a2a), dense_one_gpu_ms_median=median(
                   dense), dropped_share=float(drops[0]))
    return out


def pipeline_case(rank, n, dev):
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, forward, init_params
    from repro_torch.runtime.pipeline import (make_pipelined_forward,
                                              stage_layer_range)
    cfg = cfg_of(PIPE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev)
    for w in model.parameters():
        w.requires_grad_(True)
    mesh = make_mesh((n,), ("pod",))
    fwd = make_pipelined_forward(cfg, mesh, n)
    tokens = torch.randint(0, cfg.vocab, (PIPE_RUN["n_micro"],
                                          PIPE_RUN["bm"], PIPE_RUN["seq"]),
                           generator=gen, device=dev)

    def pipelined():
        logits = fwd(model, tokens)
        logits.float().square().mean().backward()
        return logits.detach()
    pipelined()                                     # warm-up
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    logits = pipelined()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mine = stage_layer_range(cfg, n, rank)
    names = [k for k, _ in model.named_parameters()
             if not k.startswith("layers.") or int(k.split(".")[1]) in mine]
    grads = {k: w.grad.clone() for k, w in model.named_parameters()
             if k in names}
    model.zero_grad(set_to_none=True)
    seq = torch.stack([forward(model, {"tokens": t}, cfg,
                               ShardCtx(mode="train"))[0] for t in tokens])
    seq.float().square().mean().backward()
    params = dict(model.named_parameters())
    diff = {k: float((g.float() - params[k].grad.float()).abs().max())
            / max(float(params[k].grad.float().abs().max()), 1e-30)
            for k, g in grads.items()}
    return {"case": "pipeline", "ranks": n, "arch": cfg.name,
            "layers": cfg.n_layers, **PIPE_RUN,
            "stage_layers": [mine.start, mine.stop],
            "ms": wall * 1e3, "ms_a_microbatch": wall * 1e3
            / PIPE_RUN["n_micro"],
            "logits_bit_equal": bool(torch.equal(logits, seq.detach())),
            "logits_max_diff": float((logits.float() - seq.detach().float())
                                     .abs().max()),
            "grads_bit_equal": sum(v == 0.0 for v in diff.values()),
            "grads": len(diff), "grad_worst": max(diff.items(),
                                                  key=lambda kv: kv[1])}


AUTOPLACE_REPS = 3


def autoplace_case(rank, n, dev):
    import torch

    from repro_torch import autoplace
    from repro_torch.core.machine import h100_node
    from repro_torch.launch.mesh import mesh_coords
    from repro_torch.models import ShardCtx, forward, init_params
    from repro_torch.runtime.pipeline import make_pipelined_forward
    cfg = cfg_of(PIPE_ARCH)
    plan = autoplace.place_pipeline(cfg, h100_node(1, n), scheduler="engine",
                                    n_micro=PIPE_RUN["n_micro"],
                                    seq=PIPE_RUN["seq"],
                                    micro_batch=PIPE_RUN["bm"])
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (PIPE_RUN["n_micro"],
                                          PIPE_RUN["bm"], PIPE_RUN["seq"]),
                           generator=gen, device=dev)
    identity = list(range(plan.n_stages))
    assignments = {"autoplaced": plan.stage_to_device, "identity": identity}
    if plan.stage_to_device == identity:
        assignments["reversed"] = identity[::-1]
    with torch.no_grad():
        seq = torch.stack([forward(model, {"tokens": t}, cfg,
                                   ShardCtx(mode="train"))[0]
                           for t in tokens])
        runs = {}
        for name, s2d in assignments.items():
            mesh = autoplace.stage_mesh(s2d)
            fwd = make_pipelined_forward(cfg, mesh, plan.n_stages)
            fwd(model, tokens)                          # warm-up
            times = []
            for _ in range(AUTOPLACE_REPS):
                torch.cuda.synchronize()
                torch.distributed.barrier()
                holder = []
                times.append(timed(lambda: holder.append(fwd(model,
                                                             tokens))))
            logits = holder[0]
            runs[name] = {
                "stage_to_device": s2d, "stage": mesh_coords(mesh)["pod"],
                "ms_a_microbatch": median(times) / PIPE_RUN["n_micro"],
                "logits_bit_equal": bool(torch.equal(logits, seq)),
                "logits_max_diff": float((logits.float() - seq.float())
                                         .abs().max())}
    return {"case": "autoplace", "ranks": n, "arch": cfg.name,
            "layers": cfg.n_layers, **PIPE_RUN, "plan": plan.report(),
            "runs": runs}


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch
    mag = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def tp_case(rank, n, dev):
    return {"case": "tp", **tp_compare(cfg_of(TP_ARCH), n, dev)}


def tp_compare(cfg, n, dev, f32=False):
    """``cfg`` from seed 0 (norms, Mamba's A and dt, the LoRA redrawn) on
    one GPU (every rank runs it on its whole model) and kept by
    ``shard_params`` on a (1, N) mesh, on the same batch of ``TP_RUN``:
    the gradients of one forward and backward (each rank's against its
    slice of the one-GPU gradient, per leaf), one step, ``TP_TIMED`` timed
    steps each way, the mesh run's peak GB. With ``f32`` the same
    weights also run in float32, on one GPU and kept by ``shard_params``
    on the mesh: every leaf's float32 gradient on the mesh against its
    slice of one GPU's within ``F32_COS`` (1 - cosine) and ``F32_NORM``
    (the norm ratio's distance from 1), the check of the sums; a leaf
    that misses the bf16 ``tp`` gates passes where that float32 check
    holds (small Mamba leaves, ``dt_bias``, ``A_log``, ``D``, the whole
    ``wB``/``wC``/``conv_B``/``conv_C``, are sums that cancel, and two bf16
    runs rounded in another order differ there), and its bf16 errors to
    the float32 gradient, the mesh's and one GPU's, are reported."""
    import torch

    from chip_smoke import redraw
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_ctx, mesh_axes_for
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.train_loop import make_loss_fn, make_train_step
    from repro_torch.sharding import Partitioner, shard, shard_params
    opt = OptConfig(**TP_OPT)
    mesh = make_mesh((1, n), ("data", "model"))
    axes = mesh_axes_for(cfg, mesh)
    part = Partitioner(mesh, axes)
    ctx = make_ctx(cfg, ShapeConfig("tp", TP_RUN["seq"], TP_RUN["batch"],
                                    "train"), mesh, axes)
    batch = TokenPipeline(cfg, PipelineConfig(
        batch=TP_RUN["batch"], seq_len=TP_RUN["seq"], seed=0),
        device=dev).make_batch(0)

    def model():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        return params

    def steps(params, step_ctx, specs, keep):
        """``keep`` of the gradients of one forward and backward, then
        the first step's metrics and ``keep`` of the parameters after
        it, then ``TP_TIMED`` timed steps."""
        params.requires_grad_(True)
        loss, _ = make_loss_fn(cfg, step_ctx)(params, batch)
        loss.backward()
        grads = keep({k: w.grad for k, w in params.named_parameters()})
        params.zero_grad(set_to_none=True)
        state = {"params": params, "opt": init_opt_state(params, opt)}
        step = make_train_step(cfg, opt, step_ctx, param_specs=specs)
        state, m = step(state, batch)
        first = {k: float(v) for k, v in m.items()}
        kept = keep(dict(state["params"].named_parameters()))
        ms = []
        for _ in range(TP_TIMED):
            torch.cuda.synchronize()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        del state
        return grads, first, kept, ms

    whole = model()
    specs = part.param_specs(whole)
    one_g, one, want, one_ms = steps(
        whole, ShardCtx(mode="train"), None,
        lambda tree: {k: shard(w.detach(), specs[k], mesh).clone()
                      for k, w in tree.items()})
    del whole
    cfg32 = cfg.replace(dtype="float32")

    def grads32(params, step_ctx):
        """Every leaf's float32 gradient of one forward and backward."""
        params.float().requires_grad_(True)
        make_loss_fn(cfg32, step_ctx)(params, batch)[0].backward()
        return {k: w.grad for k, w in params.named_parameters()}
    g32 = {k: shard(g, specs[k], mesh).clone() for k, g in grads32(
        model(), ShardCtx(mode="train")).items()} if f32 else {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = shard_params(model(), part)
    my_g, got, mine, tp_ms = steps(
        params, ctx, specs,
        lambda tree: {k: w.detach().clone() for k, w in tree.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    my32 = {k: g.clone() for k, g in grads32(shard_params(model(), part),
                                             ctx).items()} if f32 else {}
    grad = {}                            # leaf: (cosine, norm ratio, max)
    for k, w in one_g.items():
        a, b = my_g[k].double().reshape(-1), w.double().reshape(-1)
        na, nb = float(a.norm()), float(b.norm())
        grad[k] = (float(a @ b) / (na * nb) if na * nb else
                   float(na == nb), na / nb if nb else float(na == 0.0),
                   float((a - b).abs().max() / b.abs().max().clamp_min(
                       1e-30)))
    struct = {k: leaf_stats(my32[k], w) for k, w in g32.items()}
    f32_bad = sorted(k for k, (c, r, _) in struct.items()
                     if not (1 - c <= F32_COS and abs(r - 1) <= F32_NORM))
    missed = sorted(k for k, (c, r, _) in grad.items()
                    if not (c >= TP_GRAD_COS
                            and abs(r - 1.0) <= TP_GRAD_NORM))
    grad_bad = [k for k in missed if k not in struct] + f32_bad
    judged = {}          # a missed leaf's 1 - cos to float32: mesh, one GPU
    for k in missed:
        if k in g32:
            judged[k] = (1 - leaf_stats(my_g[k], g32[k])[0],
                         1 - leaf_stats(one_g[k], g32[k])[0])
    lr1 = float(opt.lr)                  # no warm-up: the first step's rate
    worst, apart, total = (0.0, None), 0, 0
    for k, w in want.items():
        d = (mine[k].float() - w.float()).abs()
        lim = 2 * lr1 + 2 * bf16_ulp(torch.maximum(mine[k].float().abs(),
                                                   w.float().abs()))
        r = d / lim
        i = int(r.argmax())
        if float(r.reshape(-1)[i]) > worst[0]:
            worst = (float(r.reshape(-1)[i]), k, float(w.reshape(-1)[i]),
                     float(mine[k].reshape(-1)[i]))
        apart += int((d > bf16_ulp(w)).sum())
        total += d.numel()
    heads = next(w for k, w in mine.items()
                 if k.endswith(("attn.wq", "A_log")))
    return {"ranks": n, "arch": cfg.name, "layers": cfg.n_layers, **TP_RUN,
            "mesh": [1, n], "attn_mode": ctx.attn_mode, "fsdp": axes.fsdp,
            "local_heads": heads.shape[1 if heads.dim() == 3 else 0],
            "loss": got["loss"], "one_gpu_loss": one["loss"],
            "grad_norm": got["grad_norm"],
            "one_gpu_grad_norm": one["grad_norm"],
            "loss_diff": abs(got["loss"] - one["loss"]),
            "grad_norm_rel": abs(got["grad_norm"] - one["grad_norm"])
            / one["grad_norm"],
            "grad_leaves": len(grad), "grad_bad": grad_bad,
            "grad_passed_by_f32": [k for k in missed if k not in grad_bad],
            "f32_bad": f32_bad,
            "f32_min_cos": min((c for c, _, _ in struct.values()),
                               default=None),
            "f32_worst_norm_ratio": max((r for _, r, _ in struct.values()),
                                        key=lambda r: abs(r - 1.0),
                                        default=None),
            "bf16_to_f32_worst": max(judged.items(), key=lambda kv: kv[1][0]
                                     / max(kv[1][1], 1e-12), default=None),
            "grad_min_cos": min(c for c, _, _ in grad.values()),
            "grad_worst_norm_ratio": max((r for _, r, _ in grad.values()),
                                         key=lambda r: abs(r - 1.0)),
            "grad_max_rel": max(grad.items(), key=lambda kv: kv[1][2]),
            "param_over_bound": worst[0],
            "param_worst": worst[1:],
            "param_share_past_one_ulp": apart / total,
            "step_ms": tp_ms, "one_gpu_step_ms": one_ms,
            "step_ms_median": median(tp_ms),
            "one_gpu_step_ms_median": median(one_ms),
            "peak_gb_tp": peak}


def whole_step(cfg, n, dev):
    """``cfg`` kept by ``shard_params`` on a (1, N) mesh (the optimizer
    state made at its slices), one step and ``TP_TIMED`` timed steps on
    ``TP_RUN``: what one GPU cannot hold. Returns the first step's loss
    and norm, the step ms and the peak GB a GPU from the first step on."""
    import torch

    from chip_smoke import redraw
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_ctx, mesh_axes_for
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import Partitioner
    from repro_torch.models import init_params
    opt = OptConfig(**TP_OPT)
    mesh = make_mesh((1, n), ("data", "model"))
    axes = mesh_axes_for(cfg, mesh)
    ctx = make_ctx(cfg, ShapeConfig("whole", TP_RUN["seq"], TP_RUN["batch"],
                                    "train"), mesh, axes)
    batch = TokenPipeline(cfg, PipelineConfig(
        batch=TP_RUN["batch"], seq_len=TP_RUN["seq"], seed=0),
        device=dev).make_batch(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    redraw(params, gen, dev)
    state, specs = sharded_train_state(params, opt, Partitioner(mesh, axes))
    del params
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, opt, ctx, 1, *specs)
    state, m = step(state, batch)
    first = {k: float(v) for k, v in m.items()}
    ms = []
    for _ in range(TP_TIMED):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    held = sum(w.numel() * w.element_size()
               for w in state["params"].parameters()) / 1e9
    del state
    return {"arch": cfg.name, "layers": cfg.n_layers, **TP_RUN,
            "mesh": [1, n], "fsdp": axes.fsdp, "loss": first["loss"],
            "grad_norm": first["grad_norm"], "step_ms": ms,
            "step_ms_median": median(ms), "weights_gb_a_gpu": held,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_gb_above_state": (torch.cuda.max_memory_allocated()
                                    - base) / 1e9}


def full_routes(calls, n_moe, group, b, s):
    """A teacher-forced run's router calls (``chip_smoke.recorded_routes``:
    its prefill's, one a MoE layer, by the ``a2a`` dispatch over this
    rank's chunk of the sequence, then each decode step's over every
    token) as the calls of the same run on one GPU: each prefill call's
    ids gathered over the model ranks and laid out (B, S) row-major."""
    import torch
    import torch.distributed as dist
    m = dist.get_world_size(group)
    out = []
    for i, ids in enumerate(calls):
        if i < n_moe:
            parts = [torch.empty_like(ids) for _ in range(m)]
            dist.all_gather(parts, ids.contiguous(), group=group)
            ids = torch.cat([x.reshape(b, s // m, -1) for x in parts],
                            dim=1).reshape(b * s, -1)
        out.append(ids)
    return out


def serve_compare(name, n, dev):
    """``name`` in bf16 from seed 0 (norms redrawn; a MoE's capacity
    raised so no copy drops) kept by ``shard_params`` on a (1, N) mesh:
    ``SERVE_RUN``'s prompt through ``generate`` (the main path), then its
    tokens fed back (``chip_smoke.teacher_forced``: the prefill's logits
    and each decode step's) against the same weights whole on one GPU
    (drawn again from the seed) on the same MoE routes (the mesh run's,
    gathered), within ``SERVE_REL`` of the largest logit; the caches'
    bytes a GPU beside one GPU's, at this run and at the reference's
    ``decode_32k`` (B 128 x 32,768)."""
    import torch

    from chip_smoke import recorded_routes, redraw, teacher_forced
    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_cache, init_params
    from repro_torch.runtime import generate
    from repro_torch.sharding import MeshAxes, Partitioner, shard_params
    cfg = cfg_of(name)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k * 1.01)
    b, s, g = SERVE_RUN["batch"], SERVE_RUN["prompt"], SERVE_RUN["gen"]

    def model():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        return params, gen
    mesh = make_mesh((1, n), ("data", "model"))
    part = Partitioner(mesh, MeshAxes())
    params, gen = model()
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    shard_params(params, part)
    torch.cuda.empty_cache()
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
    toks = generate(cfg, ctx, params, {"tokens": prompt}, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_routes() as calls:
        mesh_logits = teacher_forced(cfg, params, prompt, toks, ctx=ctx)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
    routes = full_routes(calls, n_moe, mesh.get_group("model"), b, s)
    del params
    torch.cuda.empty_cache()
    params, _ = model()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_routes(forced=routes if n_moe else None):
        one = teacher_forced(cfg, params, prompt, toks)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    del params
    torch.cuda.empty_cache()
    scale = float(one.abs().max())

    def cache_gb(bb, t, with_part):
        return sum(x.numel() * x.element_size() for c in init_cache(
            cfg, bb, t, device="meta", part=part if with_part else None)
            for x in c.values()) / 1e9
    big = SHAPES["decode_32k"]
    t = -(-(s + g) // n) * n                 # teacher_forced's window
    return {"arch": cfg.name, "mesh": [1, n], **SERVE_RUN,
            "max_dlogit_prefill": float((mesh_logits[:, 0] - one[:, 0])
                                        .abs().max()),
            "max_dlogit_decode": float((mesh_logits[:, 1:] - one[:, 1:])
                                       .abs().max()),
            "max_logit": scale,
            "top1_agreement": float((mesh_logits.argmax(-1)
                                     == one.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(mesh_logits).all()),
            "teacher_forced_ms": mesh_ms, "one_gpu_teacher_forced_ms": one_ms,
            "cache_gb_a_gpu": cache_gb(b, t, True),
            "one_gpu_cache_gb": cache_gb(b, t, False),
            "decode_32k_cache_gb_a_gpu": cache_gb(
                big.global_batch, big.seq_len, True),
            "decode_32k_one_gpu_cache_gb": cache_gb(
                big.global_batch, big.seq_len, False)}


def families_case(rank, n, dev):
    """Tensor parallelism of the SSM, hybrid, MLA and MoE families
    (ROADMAP A13b4) on a (1, N) mesh: mamba2-780m and zamba2-7b cut to
    ``ZAMBA_CUT`` layers, each against one GPU in bf16 and in float32
    (``tp_compare``);
    zamba2-7b whole (``whole_step``: one GPU cannot hold its training
    state); deepseek-v2-lite-16b and glm4-9b serving (``serve_compare``:
    glm4's 2 kv heads do not divide N = 4, so its caches are cut over
    their slots)."""
    zamba = cfg_of("zamba2-7b")
    train = [tp_compare(cfg_of("mamba2-780m"), n, dev, f32=True),
             tp_compare(zamba.replace(n_layers=ZAMBA_CUT), n, dev, f32=True)]
    whole = whole_step(zamba, n, dev)
    serve = [serve_compare(name, n, dev)
             for name in ("deepseek-v2-lite-16b", "glm4-9b")]
    return {"case": "families", "ranks": n, "train": train, "whole": whole,
            "serve": serve}


def bad_serve(run):
    return not run["finite"] or max(
        run["max_dlogit_prefill"], run["max_dlogit_decode"]) > \
        SERVE_REL * run["max_logit"]


def bad_tp(o):
    return o["loss_diff"] > TP_LOSS_ATOL or \
        o["grad_norm_rel"] > TP_NORM_RTOL or o["grad_bad"] or \
        o["param_over_bound"] > 1.0


def leaf_stats(a, b):
    """(cosine, norm ratio, largest difference over b's largest) of two
    tensors of one shape, summed in float64."""
    import torch
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    dot = float((a * b).sum(dtype=torch.float64))
    na = float(a.square().sum(dtype=torch.float64)) ** 0.5
    nb = float(b.square().sum(dtype=torch.float64)) ** 0.5
    return (dot / (na * nb) if na * nb else float(na == nb),
            na / nb if nb else float(na == 0.0),
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))


def fsdp_train(cfg, opt, batch, dev, mesh=None, axes=None, accum=1):
    """gemma2-style training of ``cfg`` from seed 0 (norms redrawn) on
    one GPU, or on ``mesh`` under ``axes`` (parameters and moments cut by
    ``launch.train.shard_state``): the gradients the step applies (from
    ``make_grad_fn`` before any step) and the parameters after one step,
    each as this rank's slices with their specs, kept in host memory,
    the first step's metrics, then ``TP_TIMED`` timed steps (host clock
    after a synchronise) and the run's peak GB from its first step on
    (above what was allocated before it; the whole weights drawn on each
    rank before they are cut are not counted). On a mesh the optimizer
    state is made at its slices (``launch.train.sharded_train_state``):
    glm4-9b's whole moments would not fit a GPU."""
    import torch

    from chip_smoke import redraw
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import make_ctx
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.train_loop import make_grad_fn, make_train_step
    from repro_torch.sharding import Partitioner
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    redraw(params, gen, dev)
    ctx, specs = ShardCtx(mode="train"), (None, None)
    if mesh is None:
        params.requires_grad_(True)
        state = {"params": params, "opt": init_opt_state(params, opt)}
    else:
        b, s = batch["tokens"].shape
        ctx = make_ctx(cfg, ShapeConfig("fsdp", s, b, "train"), mesh, axes)
        state, specs = sharded_train_state(params, opt,
                                           Partitioner(mesh, axes))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grads, _, _ = make_grad_fn(cfg, ctx, accum)(params, batch)
    grads = {k: grads.pop(k).detach().to("cpu") for k in list(grads)}
    step = make_train_step(cfg, opt, ctx, accum, *specs)
    state, m = step(state, batch)
    first = {k: float(v) for k, v in m.items()}
    kept = {k: w.detach().to("cpu") for k, w in params.named_parameters()}
    ms = []
    for _ in range(TP_TIMED):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    fsdp = len(params.fsdp_dims) if mesh is not None else 0
    del state, params, step
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return dict(grads=grads, params=kept, specs=specs[0], first=first,
                ms=ms, peak=peak, fsdp=fsdp,
                attn_mode=ctx.attn_mode)


def whole_leaf(run, mesh, key, k, dev):
    """Leaf ``k`` of ``run[key]`` (taken out of it) on ``dev``, gathered
    whole by its spec on ``mesh`` (as it is, without a mesh)."""
    from repro_torch.sharding import gather
    t = run[key].pop(k).to(dev)
    return t if mesh is None else gather(t, run["specs"][k], mesh)


def fsdp_case(rank, n, dev):
    """gemma2-2b on an (N, 1) mesh against one GPU over 2 microbatches,
    and glm4-9b on (N / 2, 2) against (1, N) without FSDP, both meshes'
    axes from ``mesh_axes_for`` (FSDP on) and B one row a data rank of
    ``FSDP_SEQ`` tokens: the gradient and parameter checks of ``tp``,
    each leaf gathered whole one at a time, and the step ms and peak GB
    of both runs."""
    import torch

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import mesh_axes_for
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import MeshAxes
    opt = OptConfig(**TP_OPT)
    runs = []
    for arch, shape, against in (("gemma2-2b", (n, 1), "one"),
                                 ("glm4-9b", (n // 2, 2), (1, n))):
        cfg = cfg_of(arch)
        batch = TokenPipeline(cfg, PipelineConfig(
            batch=shape[0], seq_len=FSDP_SEQ, seed=0),
            device=dev).make_batch(0)
        if against == "one":
            ref_mesh = None
            ref = fsdp_train(cfg, opt, batch, dev, accum=2)
        else:
            ref_mesh = make_mesh(against, ("data", "model"))
            ref = fsdp_train(cfg, opt, batch, dev, ref_mesh, MeshAxes())
        mesh = make_mesh(shape, ("data", "model"))
        axes = mesh_axes_for(cfg, mesh)
        got = fsdp_train(cfg, opt, batch, dev, mesh, axes)
        lr1 = float(opt.lr)
        grad, worst, apart, total = {}, (0.0, None), 0, 0
        for k in list(ref["grads"]):
            a = whole_leaf(got, mesh, "grads", k, dev)
            b = whole_leaf(ref, ref_mesh, "grads", k, dev)
            grad[k] = leaf_stats(a, b)
            del a, b
            w = whole_leaf(ref, ref_mesh, "params", k, dev)
            mine = whole_leaf(got, mesh, "params", k, dev)
            d = (mine.float() - w.float()).abs()
            lim = 2 * lr1 + 2 * bf16_ulp(torch.maximum(mine.float().abs(),
                                                       w.float().abs()))
            r = d / lim
            i = int(r.argmax())
            if float(r.reshape(-1)[i]) > worst[0]:
                worst = (float(r.reshape(-1)[i]), k,
                         float(w.reshape(-1)[i]), float(mine.reshape(-1)[i]))
            apart += int((d > bf16_ulp(w)).sum())
            total += d.numel()
            del w, mine, d, lim, r
        grad_bad = sorted(k for k, (c, r, _) in grad.items()
                          if not (c >= TP_GRAD_COS
                                  and abs(r - 1.0) <= TP_GRAD_NORM))
        one, mine = ref["first"], got["first"]
        runs.append({
            "arch": cfg.name, "mesh": list(shape), "fsdp": axes.fsdp,
            "gathered_leaves": got["fsdp"], "batch": shape[0],
            "seq": FSDP_SEQ, "attn_mode": got["attn_mode"],
            "against": "one GPU, grad_accum 2" if against == "one" else
            {"mesh": list(against), "fsdp": False},
            "loss": mine["loss"], "ref_loss": one["loss"],
            "loss_diff": abs(mine["loss"] - one["loss"]),
            "grad_norm": mine["grad_norm"], "ref_grad_norm": one["grad_norm"],
            "grad_norm_rel": abs(mine["grad_norm"] - one["grad_norm"])
            / one["grad_norm"],
            "grad_leaves": len(grad), "grad_bad": grad_bad,
            "grad_min_cos": min(c for c, _, _ in grad.values()),
            "grad_worst_norm_ratio": max((r for _, r, _ in grad.values()),
                                         key=lambda r: abs(r - 1.0)),
            "grad_max_rel": max(grad.items(), key=lambda kv: kv[1][2]),
            "param_over_bound": worst[0], "param_worst": worst[1:],
            "param_share_past_one_ulp": apart / total,
            "step_ms": got["ms"], "ref_step_ms": ref["ms"],
            "step_ms_median": median(got["ms"]),
            "ref_step_ms_median": median(ref["ms"]),
            "peak_gb": got["peak"], "ref_peak_gb": ref["peak"]})
        del got, ref
        torch.cuda.empty_cache()
    return {"case": "fsdp", "ranks": n, "runs": runs}


FSDP_CHECKS = ("loss_diff", "grad_norm_rel", "grad_bad", "grad_min_cos",
               "grad_worst_norm_ratio", "param_over_bound",
               "param_share_past_one_ulp", "step_ms_median", "peak_gb")


def bad_fsdp(run):
    return run["loss_diff"] > TP_LOSS_ATOL or \
        run["grad_norm_rel"] > TP_NORM_RTOL or run["grad_bad"] or \
        run["param_over_bound"] > 1.0 or not run["fsdp"]


CASES = {"moe": moe_case, "pipeline": pipeline_case, "tp": tp_case,
         "fsdp": fsdp_case, "families": families_case,
         "autoplace": autoplace_case}
TP_CHECKS = ("loss_diff", "grad_norm_rel", "grad_bad", "grad_min_cos",
             "grad_worst_norm_ratio", "grad_max_rel", "param_over_bound",
             "param_share_past_one_ulp")


def rank_main(rank, n, store, cases):
    import torch
    import torch.distributed as dist
    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=300))
    try:
        for name in cases:
            out = CASES[name](rank, n, dev)
            outs = [None] * n
            dist.all_gather_object(outs, out)
            if rank == 0:
                print(json.dumps(outs[0]), flush=True)
                bad = []
                if out["case"] == "tp":
                    print(json.dumps({"case": "tp ranks", "ranks": [
                        {k: o[k] for k in TP_CHECKS} for o in outs]}),
                        flush=True)
                    bad += [o for o in outs if bad_tp(o)]
                if out["case"] == "families":
                    print(json.dumps({"case": "families ranks", "ranks": [
                        [{k: r[k] for k in TP_CHECKS} for r in o["train"]]
                        + [{k: r[k] for k in ("max_dlogit_prefill",
                                              "max_dlogit_decode",
                                              "max_logit")}
                           for r in o["serve"]] for o in outs]}), flush=True)
                    bad += [r for o in outs for r in o["train"] if bad_tp(r)]
                    bad += [r for o in outs for r in o["serve"]
                            if bad_serve(r)]
                bad += [o for o in outs if o["case"] == "moe" and
                        max(o["a2a_err"], o["local_err"]) > BF16_REL]
                bad += [o for o in outs if o["case"] == "pipeline" and
                        not o["logits_bit_equal"]]
                bad += [o for o in outs if o["case"] == "autoplace" and
                        not all(r["logits_bit_equal"]
                                for r in o["runs"].values())]
                if out["case"] == "fsdp":
                    print(json.dumps({"case": "fsdp ranks", "ranks": [
                        [{k: r[k] for k in FSDP_CHECKS} for r in o["runs"]]
                        for o in outs]}), flush=True)
                    bad += [r for o in outs for r in o["runs"]
                            if bad_fsdp(r)]
                if bad:
                    raise RuntimeError(f"mesh_probe: FAIL: {json.dumps(bad)}")
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpus", type=int, default=None,
                    help="ranks (default: every visible GPU)")
    ap.add_argument("--cases", default="moe,pipeline,tp,fsdp",
                    help="comma-separated, of " + ",".join(CASES))
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}")
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build()                  # once, before the ranks load the kernels
    n = args.gpus or torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="mesh_probe_") as tmp:
        mp.spawn(rank_main, args=(n, os.path.join(tmp, "store"), cases),
                 nprocs=n)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
