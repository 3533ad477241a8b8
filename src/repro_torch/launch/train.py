"""Training entry point on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \
        --steps 300 --batch 8 --seq 512 [--reduced] [--device cpu] \
        [--ckpt-dir DIR] [--compression int8] [--from-reference DIR]

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
A mesh (``--mesh``) is refused: the sharded train step (tensor
parallelism over the mesh) comes with ROADMAP A13b2.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..checkpoint.convert import state_from_reference
from ..configs import ARCHS, reduced as reduce_cfg
from ..configs.demo import DEMO_20M, DEMO_100M
from ..data.pipeline import PipelineConfig, Prefetcher, TokenPipeline
from ..models.model import ShardCtx
from ..optim.adamw import OptConfig
from ..runtime.train_loop import Trainer, init_train_state

DEMOS = {c.name: c for c in (DEMO_100M, DEMO_20M)}


def resolve_config(name: str, reduced: bool):
    """A demo or assigned config by name; ``reduced`` gives its tiny
    same-family variant in float32 (as the reference's
    ``launch/train.resolve_config``)."""
    cfg = DEMOS.get(name) or ARCHS[name]
    if reduced:
        cfg = reduce_cfg(cfg).replace(dtype="float32")
    return cfg


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
    ap.add_argument("--mesh", default=None,
                    help="refused: the sharded train step comes with "
                         "ROADMAP A13b2")
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
    if args.mesh is not None:
        raise SystemExit(f"--mesh {args.mesh}: the sharded train step "
                         f"(tensor parallelism over a mesh) comes with "
                         f"ROADMAP A13b2")

    cfg = resolve_config(args.arch, args.reduced)
    opt = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                    total_steps=args.steps, compression=args.compression)
    ctx = ShardCtx(mode="train")
    device = torch.device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    os.makedirs(ckpt_dir, exist_ok=True)

    mgr = CheckpointManager(ckpt_dir)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.from_reference is not None:
        if mgr.list_steps():
            raise SystemExit(f"--from-reference: {ckpt_dir} already holds "
                             f"committed checkpoints {mgr.list_steps()}; "
                             f"give an empty --ckpt-dir")
        state = state_from_reference(args.from_reference, cfg, opt, device)
        start = int(state["opt"]["step"])
        resumed = (f"resumed from the reference's step {start} "
                   f"({args.from_reference})")
    elif mgr.list_steps():
        state = mgr.restore_latest(init_train_state(cfg, opt, gen, device))
        start = int(state["opt"]["step"])
        resumed = f"resumed from step {start}"
    else:
        state, start, resumed = init_train_state(cfg, opt, gen, device), 0, ""
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"arch={cfg.name} device={device} params={n_params / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")
    if resumed:
        print(resumed)
    pipe = Prefetcher(TokenPipeline(
        cfg, PipelineConfig(batch=args.batch, seq_len=args.seq,
                            seed=args.seed), device=device,
        start_step=start))
    trainer = Trainer(cfg, opt, ctx, ckpt_dir, ckpt_every=args.ckpt_every,
                      grad_accum=args.grad_accum)
    try:
        state, history, monitor = trainer.run(state, pipe, args.steps)
    finally:
        pipe.close()
    for h in history[-10:]:
        print(json.dumps(h))
    if monitor.flagged:
        print(f"straggler steps flagged: {monitor.flagged[:5]}")
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
