"""Time the run-B prefill of gemma2-2b (one 4,608-token prompt) or
mamba2-780m (one 4,000-token prompt), bf16, full width and depth, random
weights from seed 0, with the serving code and ``chip_smoke.py`` of one
checkout of this repository, either alone or after that script's
device-GA phase, so that a change in the serving path can be told from
the state that earlier phases leave on the card.

    python3 tools/prefill_probe.py [--tree DIR] [--after none|ga]
                                   [--model gemma2-2b|mamba2-780m]
                                   [--repeat N]

``--tree`` is the checkout whose ``src`` and ``chip_smoke.py`` are used
(default: this one). The probe sets the model up as ``chip_smoke.py``
does, serves run A, then run B ``--repeat`` times through ``generate``,
reading each prefill's host milliseconds as ``chip_smoke.py`` reads run
B's (the first is the one it prints), and times the prefill alone from
CUDA events. It prints the card's name and power limit, its clocks
before and after, and one JSON line. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--after", choices=("none", "ga"), default="none")
    ap.add_argument("--model", choices=("gemma2-2b", "mamba2-780m"),
                    default="gemma2-2b")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]

    import torch
    if not torch.cuda.is_available():
        print("prefill_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate, make_prefill

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(smi("name,power.limit"))
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    if args.after == "ga":
        cs.device_ga_phase(dev)

    # as chip_smoke.serve_phase / ssm_phase set the model up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_a, run_b = ((cs.RUN_A, cs.RUN_B) if args.model == "gemma2-2b"
                    else (cs.SSM_RUN_A, cs.SSM_RUN_B))
    cfg = ARCHS[args.model]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    cs.redraw(params, gen, dev)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    generate(cfg, ShardCtx(), params, {"tokens": tokens(1, 16)}, 2)
    torch.cuda.synchronize()
    prompt_a = tokens(run_a["batch"], run_a["prompt"])
    prompt_b = tokens(run_b["batch"], run_b["prompt"])
    clocks_before = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")

    def none(n_pre, n_dec):
        return {}

    cs.drive("probe", "A", run_a, cfg, params, {}, none, prompt=prompt_a)
    host_ms = [cs.drive("probe", "B", run_b, cfg, params, {}, none,
                        prompt=prompt_b)[0]["prefill_ms"]
               for _ in range(args.repeat)]
    prefill = make_prefill(cfg, ShardCtx())
    event_ms = cs.cuda_ms(lambda: prefill(params, {"tokens": prompt_b}), 5)
    print(json.dumps(dict(
        tree=str(tree), model=args.model, after=args.after,
        build_s=build_s,
        first_prefill_ms=host_ms[0], repeat_prefill_ms=host_ms[1:],
        prefill_event_ms=event_ms, clocks_before=clocks_before,
        clocks_after=smi("clocks.sm,clocks.mem,power.draw,"
                         "temperature.gpu"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
