"""One run of one cell: ``run.py --workload W --seed N --seconds T
--trace 0|1``.

The cell's configuration, traffic mix, runner, limits and per-layer
readers are found by name (:mod:`harness.registry`). The runner drives
the port and returns its end-to-end readings, the gaps that decide
``correct`` and, traced, what the readers read. The last line of
standard output is the result; the last lines of standard error give
each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from harness import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


@dataclass
class Job:
    workload: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    readers: list = field(default_factory=list)
    peaks: dict | None = None
    step_wrapper: object = None      # tests: breaks the timed path


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def make_job(args, repo: Path, device, t_start: float) -> Job:
    bench = registry.benchmark(repo)
    cell = registry.cell(bench, args.workload)
    job = Job(workload=args.workload, cell=cell,
              config=registry.config_of(bench, repo, cell["config"]),
              traffic=registry.data("traffic", cell["traffic"]),
              limits=registry.data("limits", args.workload),
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=t_start,
              end_to_end=registry.metrics_for(bench, args.workload,
                                              "end_to_end"),
              per_layer=registry.metrics_for(bench, args.workload,
                                             "per_layer"))
    if job.trace:
        job.readers = [registry.module("metrics", m["name"])
                       for m in job.per_layer]
    return job


def device_info(job, result) -> dict:
    import torch
    if job.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(job.device),
                "count": job.cell["chips"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = result["memory_peak_bytes"]
    trace = result["reading"].trace
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    if job.device.type == "cuda":
        info["power_limit"] = power_limit()
    return info


def judge(job, gaps: dict) -> tuple[bool, dict]:
    """(correct, {name: [gap, limit]}): every gap that the cell's limits
    name within its limit."""
    checks = {name: [gaps[name][0], limit] for name, limit in
              job.limits.items() if not name.startswith("_")}
    ok = all(math.isfinite(g) and g <= lim for g, lim in checks.values())
    return ok, checks


def execute(job) -> dict:
    """The result line's object for ``job``."""
    runner = registry.module("runners", job.traffic["kind"])
    result = runner.run(job)
    correct, checks = judge(job, result["gaps"])
    if job.trace:
        metrics = {}
        for entry, reader in zip(job.per_layer, job.readers):
            value = reader.read(result["reading"])
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": result["e2e"][m["name"]],
                               "unit": m["unit"]} for m in job.end_to_end}
    line = {"correct": correct and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device_info(job, result)}
    trace = result["reading"].trace
    if trace is not None:
        line["breakdown"] = {"device_ops": trace.top_device_ops(),
                             "idle_gaps": trace.idle_by_host()}
    line["checks"] = checks
    line["_gaps"] = result["gaps"]
    return line


def main(argv=None, repo: Path | None = None, t_start: float | None = None
         ) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    repo = repo or registry.BENCH.parent
    job = make_job(args, repo, None, t_start)
    if torch.cuda.device_count() < job.cell["chips"]:
        print(f"{args.workload} needs {job.cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    job.device = torch.device("cuda:0")
    torch.cuda.set_device(job.device)
    job.peaks = registry.load_json(registry.BENCH / "harness" /
                                   "peaks.json").get(
        torch.cuda.get_device_name(job.device))
    return report(execute(job))


def report(line: dict) -> int:
    """Prints the checks on standard error and the result on standard
    output; refuses (exit 3, no result) where JAX or the JAX package was
    loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    gaps = line.pop("_gaps")
    for name, (gap, where) in gaps.items():
        if name not in line["checks"]:
            print(f"reading {name} {gap!r} ({where}), not compared",
                  file=sys.stderr)
    for name, (gap, limit) in line["checks"].items():
        print(f"check {name} {gap!r} limit {limit!r} ({gaps[name][1]})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
