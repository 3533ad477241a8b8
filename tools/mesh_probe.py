"""Run the port's expert-parallel MoE dispatch and GPipe pipeline across
the GPUs of one host, one process a GPU on NCCL, held to one GPU's
answer and timed.

    python3 tools/mesh_probe.py [--gpus N]

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

Prints one JSON line per case (rank 0's) and, last, the card's name and
power limit. Exits non-zero when a check fails: an output off the dense
dispatch's by more than 2e-2 of its largest, or pipelined logits not bit
for bit. The same dispatches and pipeline run on gloo CPU ranks in
``tests/test_torch_moe_ep.py`` and ``tests/test_torch_pipeline.py``.
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


def rank_main(rank, n, store):
    import torch
    import torch.distributed as dist
    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=300))
    try:
        for case in (moe_case, pipeline_case):
            out = case(rank, n, dev)
            outs = [None] * n
            dist.all_gather_object(outs, out)
            if rank == 0:
                print(json.dumps(outs[0]), flush=True)
                bad = [o for o in outs if o["case"] == "moe" and
                       max(o["a2a_err"], o["local_err"]) > BF16_REL]
                bad += [o for o in outs if o["case"] == "pipeline" and
                        not o["logits_bit_equal"]]
                if bad:
                    raise RuntimeError(f"mesh_probe: FAIL: {json.dumps(bad)}")
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpus", type=int, default=None,
                    help="ranks (default: every visible GPU)")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build()                  # once, before the ranks load the kernels
    n = args.gpus or torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="mesh_probe_") as tmp:
        mp.spawn(rank_main, args=(n, os.path.join(tmp, "store")), nprocs=n)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
