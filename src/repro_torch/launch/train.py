"""Training entry point, on one device or on a ``("data", "model")``
mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \
        --steps 300 --batch 8 --seq 512 [--reduced] [--device cpu] \
        [--ckpt-dir DIR] [--compression int8] [--from-reference DIR] \
        [--mesh DxM]

Runs the fault-tolerant ``Trainer`` (checkpoints, retry, straggler
monitor) on seeded synthetic data (``TokenPipeline`` behind a
``Prefetcher``), resuming from the latest committed checkpoint in
``--ckpt-dir`` when there is one. ``--from-reference DIR`` starts from a
checkpoint the JAX package's trainer wrote instead (a checkpoint
directory, its latest committed step, or one ``step_XXXXXXXX``;
:func:`repro_torch.checkpoint.state_from_reference`), at that
checkpoint's step, and refuses when ``--ckpt-dir`` already holds a
committed checkpoint of the port (the resume point would be ambiguous);
the run then writes the port's own checkpoints to ``--ckpt-dir``.
``--arch`` names a demo or an assigned config of any family: dense,
MoE, SSM (``mamba2-780m``), hybrid
(``zamba2-7b``), the encoder (``hubert-xlarge``) or the VLM
(``paligemma-3b``). ``--reduced`` gives the config's tiny same-family
variant in float32. Runs on the card unless ``--device cpu`` is given.

``--mesh DxM`` trains tensor-parallel over M ranks and data-parallel
over D (every family: the SSM and hybrid layers' heads, MLA's heads and
MoE's experts over M too): one process a device,
D x M of them, started by ``torchrun --nproc-per-node N`` (NCCL, one
card a rank) or, with ``--device cpu``, as gloo ranks
(:func:`repro_torch.launch.mesh.spawn_cpu_ranks` joins them and calls
:func:`main` in each). A world of another size is refused. Every rank
builds the same state from ``--seed`` (or restores it), keeps its slice
(:func:`repro_torch.sharding.shard_params`; FSDP over the data axes
where :func:`repro_torch.launch.specs.mesh_axes_for` turns it on, and
the moments, with ``--compression int8``'s residual, at their ZeRO-1
specs) and runs the sharded train step on its rows of the same seeded
batches; rank 0 prints, and checkpoints are saved and restored through
``shardings=`` (whole leaves on disk, restorable on one device or
another mesh).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from ..checkpoint.ckpt import CheckpointManager
from ..checkpoint.convert import state_from_reference
from ..configs import ARCHS, ShapeConfig, reduced as reduce_cfg
from ..configs.demo import DEMO_20M, DEMO_100M
from ..data.pipeline import PipelineConfig, Prefetcher, TokenPipeline
from ..models.model import ShardCtx, init_params
from ..optim.adamw import OptConfig, init_opt_state
from ..runtime.train_loop import Trainer, init_train_state, state_shardings
from ..sharding.partition import (Partitioner, shard, shard_params,
                                  shard_slices)
from .mesh import BACKENDS, make_mesh
from .specs import make_ctx, mesh_axes_for

DEMOS = {c.name: c for c in (DEMO_100M, DEMO_20M)}


def resolve_config(name: str, reduced: bool):
    """A demo or assigned config by name; ``reduced`` gives its tiny
    same-family variant in float32 (as the reference's
    ``launch/train.resolve_config``)."""
    cfg = DEMOS.get(name) or ARCHS[name]
    if reduced:
        cfg = reduce_cfg(cfg).replace(dtype="float32")
    return cfg


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> (D, M), both positive."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: give DxM, e.g. 2x4") from None
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text!r}: both sizes must be >= 1")
    return d, m


def join_mesh(text: str, device: torch.device):
    """The ``("data", "model")`` mesh of ``--mesh``, over the process
    group the launcher started (``torchrun`` sets the environment; the
    group is initialised here on its backend) or the one already
    initialised (gloo ranks); returns (mesh, device of this rank)."""
    d, m = parse_mesh(text)
    n = d * m
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh {text} needs {n} ranks: start them with torchrun "
                f"--nproc-per-node {n} (NCCL), or as gloo ranks with "
                f"--device cpu (launch.mesh.spawn_cpu_ranks)")
        if device.type == "cuda":      # this rank's card before NCCL
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(BACKENDS[device.type])
    if dist.get_world_size() != n:
        raise SystemExit(f"--mesh {text} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         dist.get_rank())))
        torch.cuda.set_device(device)
    return make_mesh((d, m), ("data", "model"),
                     device_type=device.type), device


def shard_state(state: dict, part: Partitioner) -> tuple[dict, dict]:
    """``state`` with its parameters (:func:`shard_params`) and moments
    (``m``, ``v`` and ``ef``, at :meth:`Partitioner.moment_specs`) cut to
    this rank's slices, in place; returns the specs of the parameters
    and of the moments."""
    specs = part.param_specs(state["params"])
    moments = part.moment_specs(state["params"], specs)
    shard_params(state["params"], part)
    for key in ("m", "v", "ef"):
        if key in state["opt"]:
            state["opt"][key] = {k: shard(t, moments[k], part.mesh)
                                 for k, t in state["opt"][key].items()}
    return specs, moments


def sharded_train_state(params, opt: OptConfig,
                        part: Partitioner) -> tuple[dict, tuple[dict, dict]]:
    """A fresh train state on this rank of ``part``'s mesh from whole
    parameters (every rank holding the same): the parameters cut to this
    rank's slices (:func:`shard_params`) and made trainable, and the
    optimizer state made at its slices (the moments at
    :meth:`Partitioner.moment_specs`), so no rank holds the whole
    moments. Returns (state, (param specs, moment specs))."""
    params.requires_grad_(True)
    specs = part.param_specs(params)
    moments = part.moment_specs(params, specs)
    shapes = {k: tuple(s.stop - s.start for s in shard_slices(
        p.shape, moments[k], part.mesh)) for k, p in
        params.named_parameters()}
    shard_params(params, part)
    return ({"params": params, "opt": init_opt_state(params, opt, shapes)},
            (specs, moments))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config in float32 (CI)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="data x model ranks (torchrun, or gloo ranks "
                         "with --device cpu)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--from-reference", default=None, metavar="DIR",
                    help="start from a checkpoint of the JAX package's "
                         "trainer")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    opt = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                    total_steps=args.steps, compression=args.compression)
    ctx = ShardCtx(mode="train")
    device = torch.device(args.device)
    part = shardings = None
    started = args.mesh is not None and not dist.is_initialized()
    if args.mesh is not None:
        mesh, device = join_mesh(args.mesh, device)
        axes = mesh_axes_for(cfg, mesh)
        part = Partitioner(mesh, axes)
        ctx = make_ctx(cfg, ShapeConfig("cli", args.seq, args.batch,
                                        "train"), mesh, axes)
    lead = part is None or dist.get_rank() == 0
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None and lead:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    if part is not None:        # one directory: rank 0's
        shared = [ckpt_dir]
        dist.broadcast_object_list(shared, src=0)
        ckpt_dir = shared[0]
    os.makedirs(ckpt_dir, exist_ok=True)

    mgr = CheckpointManager(ckpt_dir)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def fresh():
        if part is not None:
            return sharded_train_state(init_params(cfg, gen, device), opt,
                                       part)
        return init_train_state(cfg, opt, gen, device), (None, None)
    if args.from_reference is not None:
        if mgr.list_steps():
            raise SystemExit(f"--from-reference: {ckpt_dir} already holds "
                             f"committed checkpoints {mgr.list_steps()}; "
                             f"give an empty --ckpt-dir")
        state = state_from_reference(args.from_reference, cfg, opt, device)
        specs = shard_state(state, part) if part is not None else (None,
                                                                   None)
        start = int(state["opt"]["step"])
        resumed = (f"resumed from the reference's step {start} "
                   f"({args.from_reference})")
    elif mgr.list_steps():
        state, specs = fresh()
        if part is not None:
            shardings = state_shardings(part.mesh, *specs)
        state = mgr.restore_latest(state, shardings)
        start = int(state["opt"]["step"])
        resumed = f"resumed from step {start}"
    else:
        (state, specs), start, resumed = fresh(), 0, ""
    n_params = sum(p.numel() for p in state["params"].parameters())
    if lead:
        print(f"arch={cfg.name} device={device} params={n_params / 1e6:.1f}M"
              f"{' a rank' if part else ''} steps={args.steps} "
              f"batch={args.batch} seq={args.seq}"
              + (f" mesh={args.mesh} attn_mode={ctx.attn_mode}"
                 f" fsdp={part.axes.fsdp} moments="
                 f"{'zero1' if specs[1] != specs[0] else 'params'}"
                 if part else ""))
        if resumed:
            print(resumed)
    pipe = Prefetcher(TokenPipeline(
        cfg, PipelineConfig(batch=args.batch, seq_len=args.seq,
                            seed=args.seed), device=device,
        start_step=start))
    trainer = Trainer(cfg, opt, ctx, ckpt_dir, ckpt_every=args.ckpt_every,
                      grad_accum=args.grad_accum, param_specs=specs[0],
                      moment_specs=specs[1])
    try:
        state, history, monitor = trainer.run(state, pipe, args.steps)
    finally:
        pipe.close()
        if started:
            dist.destroy_process_group()
    if lead:
        for h in history[-10:]:
            print(json.dumps(h))
        if monitor.flagged:
            print(f"straggler steps flagged: {monitor.flagged[:5]}")
        if history:
            print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
