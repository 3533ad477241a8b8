"""Serving entry point: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 512 --gen 32 [--reduced] [--device cpu]

``--arch`` names a demo or an assigned config of a served family: dense
(``gemma2-2b``, ...), MoE (``deepseek-v2-lite-16b`` with MLA,
``qwen3-moe-235b-a22b`` with GQA; on one 80 GB card the latter fits
only cut in depth, which this CLI does not do), SSM (``mamba2-780m``) or
hybrid (``zamba2-7b``), or the VLM (``paligemma-3b``, whose prompt
also carries ``n_patches`` seeded N(0, 1) patch embeddings, as the
reference CLI draws them); ``--reduced`` gives any of them tiny, in
float32, for the CPU (``--reduced --device cpu``). The encoder
(``hubert-xlarge``, frame frontend) has no decode step and is refused.
Weights are random (``init_params`` seeded with ``--seed``); the prompt
is ``--batch`` rows of seeded token ids. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.model import ShardCtx, init_params
from ..runtime.serve_loop import generate
from .train import resolve_config


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
    if cfg.frontend == "frame_stub":
        raise SystemExit(f"{cfg.name} is an encoder (frame frontend): it has "
                         f"no decode step to serve; train it with "
                         f"repro_torch.launch.train")
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompt = {"tokens": torch.randint(0, cfg.vocab,
                                      (args.batch, args.prompt_len),
                                      generator=gen, device=device)}
    if cfg.frontend == "patch_stub":
        prompt["patches"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model), generator=gen,
            device=device)

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
