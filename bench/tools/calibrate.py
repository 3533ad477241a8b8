"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size, in one process:

    python3 bench/tools/calibrate.py --workload W --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--out FILE]

For each seed: the port's first steps against the float32 reference
(the lower readings); for each control seed, the reference computed on
fp8 operands put in the program's place (the control); for each fault
seed, two faults planted in the port's step: half of each batch left
out, the mean taken over the rest, and the loss it reports altered by
1 % (a step that returns its state unchanged reads 1 on every gradient
and change gap and needs no run). One JSON line a reading, and with
``--leaves`` each reading's leaf norms; no window is timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    import torch

    from harness import faults
    from harness import main as hm
    from harness import registry
    runner = registry.module("runners", "train")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--leaves", help="file for each reading's leaf norms")
    args = ap.parse_args(argv)
    dev = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def job_for(seed):
        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=0.0, trace=0)
        return hm.make_job(ns, BENCH.parent, dev, time.perf_counter())

    def port(job, wrapper=None):
        family = registry.module("reference", job.config["family"])
        spec = family.param_spec(job.config)
        pool = runner.batches(job)
        step, state = runner.build_state(job, spec)
        if wrapper is not None:
            step = wrapper(step)
        prog, _ = runner.first_steps(job, step, state, pool, spec,
                                     torch.cuda.synchronize)
        del step, state
        torch.cuda.empty_cache()
        return family, spec, pool, prog

    leaves = open(args.leaves, "a") if args.leaves else None
    for kind, seeds in (("port", args.seeds),
                        ("control", args.control_seeds),
                        ("half_batch", args.fault_seeds),
                        ("answer_altered", args.fault_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            job = job_for(seed)
            if kind == "control":
                family = registry.module("reference", job.config["family"])
                spec = family.param_spec(job.config)
                pool = runner.batches(job)
                prog = runner.reference_outputs(job, family, spec, pool,
                                                "fp8")
            else:
                family, spec, pool, prog = port(job, getattr(faults, kind,
                                                             None))
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            ref = runner.reference_outputs(job, family, spec, pool,
                                           routes=prog.pop("routes"))
            gaps = runner.compare(prog, ref)
            emit({"workload": args.workload, "kind": kind, "seed": seed,
                  **{k: v[0] for k, v in gaps.items()},
                  "worst": {k: v[1] for k, v in gaps.items()},
                  "losses": prog["losses"], "ref_losses": ref["losses"],
                  "ref_s": time.perf_counter() - t1,
                  "ref_peak_bytes": torch.cuda.max_memory_allocated(),
                  "s": time.perf_counter() - t0})
            if leaves:
                leaves.write(json.dumps({
                    "workload": args.workload, "kind": kind, "seed": seed,
                    "prog": {k: prog[k] for k in ("grad_norms", "deltas")},
                    "ref": {k: ref[k] for k in ("grad_norms", "deltas")}})
                    + "\n")
    for f in (out, leaves):
        if f:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
