#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root (it puts ``src`` on ``sys.path`` itself):

    python3 chip_smoke.py

1. Builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
   and prints nvcc's register/spill report.
2. Main path, at the paper's real suite sizes: synthetic MPAHA suites
   (the 64-core paper suite on hp_bl260c; 4 apps of 240-280 tasks on a
   256-core cluster of multicores), mapped with AMTHA
   (``get_scheduler("engine")``), then evaluated on the card with
   ``simulate_suite(backend="cuda")`` at jitter 0 and at jitter 0.01 with
   16 draws per app. The kernels' launch counts are zeroed just before
   and read just after.
3. Checks: every result against the float64 NumPy backend at rtol 1e-5
   (one float32 rounding per relaxation step); T_exec == T_est at jitter
   0 (the analytic simulator reproduces the schedule); the kernel equal
   to its plain PyTorch version with ``torch.equal`` on the same device
   tensors at every main-path shape; a non-zero launch count.
4. Numbers: per shape, the kernel's time from CUDA events, the plain
   version's, the bound and what bounds it; a host-side breakdown of
   ``simulate_batch``.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run outside a checkout. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12              # H100 SXM float32 rate outside tensor cores
RTOL_F32 = 1e-5                     # the reference's float32 tolerance
JITTER, DRAWS = 0.01, 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls, from
    CUDA events, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on a GPU)")
    import numpy as np

    from repro_torch.core import (SynthParams, batch_scenarios,
                                  cluster_of_multicores, generate_app,
                                  get_scheduler, hp_bl260c, lower_scenario,
                                  paper_suite_64core, simulate_suite)
    from repro_torch.core.sim_engine import (_jitter_durations,
                                             _pop_gather_inputs,
                                             simulate_batch)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sim_step import (sim_relax_pop_cuda,
                                              sim_relax_pop_torch)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {len(built)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for k in built.values():
        for line in k.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    # -- 2. main path ---------------------------------------------------
    suites = [
        ("64core", hp_bl260c(), paper_suite_64core(n_apps=10, seed=100)),
        ("256core", cluster_of_multicores(32),
         [generate_app(SynthParams(n_tasks=(240, 280)), seed=300 + i)
          for i in range(4)]),
    ]
    counters = {"sim_relax_pop": ops.sim_relax_pop}
    for fn in counters.values():
        fn.launches = 0
    mapper = get_scheduler("engine")
    runs = []
    for name, machine, graphs in suites:
        t0 = time.perf_counter()
        schedules = [mapper(g, machine) for g in graphs]
        map_s = time.perf_counter() - t0
        for tag, jitter, draws in (("plain", 0.0, 1),
                                   ("jitter", JITTER, DRAWS)):
            gs, ss = graphs * draws, schedules * draws
            seeds = list(range(len(gs)))
            t0 = time.perf_counter()
            res = simulate_suite(gs, machine, ss, jitter=jitter, seeds=seeds,
                                 backend="cuda", device=dev)
            runs.append(dict(name=f"{name}-{tag}", machine=machine,
                             graphs=gs, schedules=ss, jitter=jitter,
                             seeds=seeds, res=res, map_s=map_s,
                             suite_s=time.perf_counter() - t0))
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"main path launches: {launches}")
    for k, n in launches.items():
        if n == 0:
            fail(f"kernel {k} was never launched on the main path")

    # -- 3. checks ------------------------------------------------------
    for r in runs:
        res = r["res"]
        ref = simulate_suite(r["graphs"], r["machine"], r["schedules"],
                             jitter=r["jitter"], seeds=r["seeds"],
                             backend="numpy")
        if res.subtask_end.shape != ref.subtask_end.shape:
            fail(f"{r['name']}: shape {res.subtask_end.shape} != "
                 f"{ref.subtask_end.shape}")
        if not np.isfinite(res.subtask_end).all():
            fail(f"{r['name']}: non-finite finish times")
        err = np.abs(res.subtask_end - ref.subtask_end) \
            / np.maximum(np.abs(ref.subtask_end), 1e-30)
        if not np.allclose(res.subtask_end, ref.subtask_end, rtol=RTOL_F32,
                           atol=0.0):
            fail(f"{r['name']}: cuda vs float64 rel err {err.max():.3e} "
                 f"> {RTOL_F32}")
        dif = res.dif_rel()
        if r["jitter"] == 0.0 and np.abs(dif).max() > 100 * RTOL_F32:
            fail(f"{r['name']}: T_exec != T_est without jitter "
                 f"(max |dif_rel| {np.abs(dif).max():.3e}%)")
        b, s = res.subtask_end.shape
        print(f"{r['name']}: machine={r['machine'].name!r} B={b} S={s} "
              f"dif_rel mean={dif.mean():.4f}% max={dif.max():.4f}% "
              f"rel_err_vs_f64={err.max():.3e} map_s={r['map_s']:.3f} "
              f"simulate_suite_s={r['suite_s']:.3f}")

    # -- 4. kernel vs plain, timings, bound, host breakdown -------------
    kernel_rows, breakdowns = [], []
    for r in runs:
        scen = [lower_scenario(g, r["machine"], sc)
                for g, sc in zip(r["graphs"], r["schedules"])]
        batch = batch_scenarios(scen)
        dur = _jitter_durations(batch, r["jitter"], r["seeds"])
        pred, lat, volbw = _pop_gather_inputs(batch)
        args = [torch.from_numpy(x).to(dev) for x in
                (pred, lat, volbw, dur.astype(np.float32),
                 batch.release.astype(np.float32))]
        steps = batch.depth
        got = ops.sim_relax_pop(*args, n_steps=steps)
        want = sim_relax_pop_torch(*args, n_steps=steps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{r['name']}: kernel != plain version, max abs err "
                 f"{(got - want).abs().max().item():.3e}")
        max_err = (got - want).abs().max().item()
        b, s, p1 = pred.shape
        ms = cuda_ms(lambda: sim_relax_pop_cuda(*args, n_steps=steps), 20)
        plain_ms = cuda_ms(lambda: sim_relax_pop_torch(*args, n_steps=steps),
                           5)
        n_bytes = sum(x.numel() * x.element_size() for x in args) + b * s * 4
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = b * s * p1 * 3 / FP32_OPS_PER_S * 1e3
        row = dict(name=r["name"], B=b, S=s, P1=p1, depth=steps,
                   max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=n_bytes)
        kernel_rows.append(row)
        print("sim_relax_pop " + json.dumps(row))

        # host-side breakdown of one simulate_batch call on a fresh batch
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate_batch(batch_scenarios(scen), jitter=r["jitter"],
                       seeds=r["seeds"], backend="cuda", device=dev)
        torch.cuda.synchronize()
        times["simulate_batch_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        fresh = batch_scenarios(scen)
        times["batch_scenarios_s"] = time.perf_counter() - t
        t = time.perf_counter()
        dur = _jitter_durations(fresh, r["jitter"], r["seeds"])
        times["jitter_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host = _pop_gather_inputs(fresh)
        times["gather_inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host = host + (dur.astype(np.float32),
                       fresh.release.astype(np.float32))
        times["cast_s"] = time.perf_counter() - t
        t = time.perf_counter()
        dargs = [torch.from_numpy(x).to(dev) for x in host]
        torch.cuda.synchronize()
        times["upload_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ops.check_gather_bounds("pred", dargs[0], s)
        times["bounds_check_s"] = time.perf_counter() - t
        t = time.perf_counter()
        end = sim_relax_pop_cuda(*dargs, n_steps=steps)
        torch.cuda.synchronize()
        times["kernel_s"] = time.perf_counter() - t
        t = time.perf_counter()
        np.where(fresh.valid, end.cpu().numpy().astype(np.float64), 0.0)
        times["download_mask_s"] = time.perf_counter() - t
        breakdowns.append(dict(name=r["name"], **times))
        print("breakdown " + json.dumps(breakdowns[-1]))

    main_row = max(kernel_rows, key=lambda x: x["bytes"])
    print(json.dumps({"kernels": [dict(
        name="sim_relax_pop", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_relax_pop.cu",
        replaces="src/repro/kernels/sim_step.py:184",
        launches=launches["sim_relax_pop"],
        max_abs_err=max(x["max_abs_err"] for x in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"])]}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
