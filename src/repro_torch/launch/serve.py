"""Serving entry point: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 512 --gen 32 [--reduced] [--device cpu]

``--arch`` names a demo or an assigned config of a served family: dense
(``gemma2-2b``, ...), SSM (``mamba2-780m``) or hybrid (``zamba2-7b``).
Weights are random (``init_params`` seeded with ``--seed``); the prompt
is ``--batch`` rows of seeded token ids. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, reduced as reduce_cfg
from ..configs.demo import DEMO_20M, DEMO_100M
from ..models.model import ShardCtx, init_params
from ..runtime.serve_loop import generate

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
    ap.add_argument("--arch", default="demo-20m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompt = {"tokens": torch.randint(0, cfg.vocab,
                                      (args.batch, args.prompt_len),
                                      generator=gen, device=device)}

    t0 = time.perf_counter()
    out = generate(cfg, ShardCtx(), params, prompt, n_tokens=args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} generated={args.gen} wall={dt:.2f}s "
          f"tok/s={args.batch * args.gen / dt:.1f}")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
