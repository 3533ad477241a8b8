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
5. Online path, at 256 cores (``cluster_of_multicores(n_blades=32)``):
   64 bursty arrivals at rho=0.9 admitted by
   ``make_policy("batched", k=16, scorer="kernel", device="cuda")``
   (the hand-written ``sched_score`` kernel), validated and evaluated
   with contention; then a random fault script (one core failure, one
   slowdown, one link degrade, all in 0.2-0.4 of the makespan) detected
   at half the makespan and recovered by ``recover_from_script`` with
   the GA refinement, whose fitness runs ``sim_relax_pop`` on the card
   at merged-cluster shapes. Both kernels' counts are zeroed just before
   and read just after. Checks: placements equal to the same admission
   with ``device="cpu"`` (the plain version), exactly; ``sched_score``
   equal to its plain version under ``torch.equal`` at every shape the
   path launched, at a ragged stress shape and with +-inf, and with NaN
   propagated at the same places; ``sim_relax_pop`` equal to its plain
   version at the GA's shapes; the GA's first population's fitness on
   the card within rtol 1e-5 of float64; both kernels launched; the
   GA-refined makespan at most that of the greedy re-map it starts from
   (losing a core may lengthen the plan, the GA must not);
   ``validate()`` after admission and after recovery. Numbers:
   kernel/plain/bound ms and launches, admission/evaluate/recovery wall
   seconds with a host breakdown of their layers, the recovery report.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run outside a checkout. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
ONLINE_BLADES, ONLINE_APPS, ONLINE_K = 32, 64, 16   # 256 cores
MEAN_APP_WORK_S = 550               # benchmarks/online_bench.py: rho units


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


def snapshot(x):
    """A copy of one recorded argument that later work cannot change."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return np.array(x)
    return x


class Spy:
    """Stands in for ``module.name`` while the main path runs and keeps
    the first arguments of each distinct ``key(args)``; every call goes
    on to the real function, whose own count is untouched."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key = module, name, key
        self.fn = getattr(module, name)
        self.calls = {}

    @property
    def launches(self):
        """The real entry point's count: it counts through its module
        name, which is this spy while the spy stands in."""
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        k = self.key(args)
        if k not in self.calls:
            self.calls[k] = ([snapshot(a) for a in args],
                             {n: snapshot(v) for n, v in kwargs.items()})
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Timed:
    """Adds up the host wall seconds of every call to ``owner.name``
    while it stands in. The stand-in is a plain function, so a method
    put on a class still binds."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        fn = self.fn

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def shapes(args):
    return tuple(tuple(a.shape) for a in args)


def placements(sch):
    return {sid: (p.core, p.start, p.end)
            for sid, p in sch.placements.items()}


def same_scores(got, want) -> bool:
    """Equal under ``torch.equal`` where the score is a number, NaN at
    the same places (only a NaN's payload may differ)."""
    import torch
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def sim_row(name, args, steps, ops, sim_relax_pop_cuda, sim_relax_pop_torch):
    """Kernel vs plain on the same device tensors, times and bound."""
    import torch
    got = ops.sim_relax_pop(*args, n_steps=steps)
    want = sim_relax_pop_torch(*args, n_steps=steps)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: kernel != plain version, max abs err "
             f"{(got - want).abs().max().item():.3e}")
    b, s, p1 = args[0].shape
    ms = cuda_ms(lambda: sim_relax_pop_cuda(*args, n_steps=steps), 20)
    plain_ms = cuda_ms(lambda: sim_relax_pop_torch(*args, n_steps=steps), 5)
    n_bytes = sum(x.numel() * x.element_size() for x in args) + b * s * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = b * s * p1 * 3 / FP32_OPS_PER_S * 1e3
    return dict(name=name, B=b, S=s, P1=p1, depth=steps,
                max_abs_err=(got - want).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on a GPU)")
    import numpy as np

    from repro_torch.core import (SynthParams, batch_scenarios,
                                  cluster_of_multicores, generate_app,
                                  get_scheduler, hp_bl260c, lower_scenario,
                                  paper_suite_64core, simulate_suite)
    from repro_torch.core import lowering, sim_engine
    from repro_torch.core.sim_engine import (_jitter_durations,
                                             _pop_gather_inputs,
                                             simulate_batch)
    from repro_torch.faults import random_script
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sched_score import (sched_score_cuda,
                                                 sched_score_torch)
    from repro_torch.kernels.sim_step import (sim_relax_pop_cuda,
                                              sim_relax_pop_torch)
    from repro_torch.online import (ArrivalParams, BatchedPolicy,
                                    OnlineAMTHA, RecoveryParams, evaluate,
                                    generate_workload, make_policy,
                                    recover_from_script)
    from repro_torch.search import GAParams, ga, local

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
    counters = {"sim_relax_pop": ops.sim_relax_pop,
                "sched_score": ops.sched_score}
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
    print(f"offline path launches: {launches}")
    if launches["sim_relax_pop"] == 0:
        fail("kernel sim_relax_pop was never launched on the offline path")

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
        steps, s = batch.depth, batch.max_subtasks
        row = sim_row(r["name"], args, steps, ops, sim_relax_pop_cuda,
                      sim_relax_pop_torch)
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

    # -- 5. online admission + fault recovery at 256 cores --------------
    machine = cluster_of_multicores(n_blades=ONLINE_BLADES)
    n_cores = machine.n_cores
    workload = generate_workload(
        ArrivalParams(rate=0.9 * n_cores / MEAN_APP_WORK_S,
                      process="bursty"), n_apps=ONLINE_APPS, seed=3)
    n_sub = sum(a.graph.n_subtasks for a in workload)
    ga_params = GAParams(pop_size=16, generations=10, refine_rounds=2,
                         refine_moves=32, backend="cuda")
    wall = {}
    for fn in counters.values():
        fn.launches = 0
    # host wall seconds of the phase's layers (see PERF.md section 5)
    timers = {"admit": (OnlineAMTHA, "admit"),
              "kernel_scores": (BatchedPolicy, "kernel_scores"),
              "ga_decode": (ga, "decode_population"),
              "hill_decode": (local, "decode_population"),
              "lower_population": (lowering, "lower_population"),
              "relax_upload_kernel_download": (sim_engine, "_relax_pop"),
              "simulate_batch_ga": (ga, "batch_fitness"),
              "simulate_batch_hill": (local, "batch_fitness")}
    with contextlib.ExitStack() as stack:
        timed = {k: stack.enter_context(Timed(*v))
                 for k, v in timers.items()}
        score_spy = stack.enter_context(Spy(ops, "sched_score", shapes))
        relax_spy = stack.enter_context(Spy(ops, "sim_relax_pop", shapes))
        fit_spy = stack.enter_context(
            Spy(ga, "population_fitness", lambda args: "first"))
        t0 = time.perf_counter()
        state = make_policy("batched", k=ONLINE_K, scorer="kernel",
                            device=dev).run(machine, workload)
        torch.cuda.synchronize()
        wall["admission_s"] = time.perf_counter() - t0
        state.validate()
        admitted = placements(state.schedule)
        t0 = time.perf_counter()
        healthy = evaluate(state, contention=True)
        wall["evaluate_s"] = time.perf_counter() - t0
        makespan = state.schedule.makespan()
        script = random_script(n_cores, seed=5, horizon=makespan, n_fail=1,
                               n_slow=1, n_degrade=1, protect=(0,),
                               t_window=(0.2, 0.4))
        engine = OnlineAMTHA(machine)
        engine.state = state
        refined = []                # refine_ga's (greedy, refined) makespans
        refine_ga = engine.refine_ga

        def recorded_refine(**kw):
            t = time.perf_counter()
            refined.append(refine_ga(**kw))
            wall["recovery_ga_s"] = time.perf_counter() - t
            return refined[-1]
        engine.refine_ga = recorded_refine
        t0 = time.perf_counter()
        report = recover_from_script(
            engine, script, 0.5 * makespan,
            RecoveryParams(ga_refine=True, ga_params=ga_params))
        torch.cuda.synchronize()
        wall["recovery_s"] = time.perf_counter() - t0
        engine.state.validate()
        t0 = time.perf_counter()
        faulty = evaluate(engine.state, faults=script)
        wall["evaluate_faults_s"] = time.perf_counter() - t0
    online_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"online path launches: {online_launches}")
    print("online breakdown " + json.dumps(
        {k: dict(s=t.seconds, calls=t.calls) for k, t in timed.items()}))
    for k, n in online_launches.items():
        if n == 0:
            fail(f"kernel {k} was never launched on the online path")
    print(f"online: cores={n_cores} apps={len(workload)} subtasks={n_sub} "
          f"makespan={makespan!r} " + json.dumps(wall))
    print("online metrics " + json.dumps(healthy.row()))
    print("online metrics under faults " + json.dumps(faulty.row()))
    rep = {k: v for k, v in vars(report).items() if k != "notes"}
    rep["notes"] = report.notes
    print("recovery report " + json.dumps(rep))
    for name, met in (("healthy", healthy), ("faults", faulty)):
        if met.n_apps != len(workload) or not np.isfinite(met.span):
            fail(f"online metrics ({name}) malformed: {met.row()}")
    # losing a core may lengthen the plan; the GA pass must not
    if len(refined) != 1:
        fail(f"recovery ran the GA refinement {len(refined)} times, not once")
    greedy_ms, refined_ms = refined[0]
    print(f"recovery makespans: before faults {report.old_makespan!r}, "
          f"greedy re-map {greedy_ms!r}, after GA {refined_ms!r}")
    if not refined_ms <= greedy_ms or report.new_makespan != refined_ms:
        fail(f"GA-refined makespan {refined_ms!r} exceeds the recovered "
             f"{greedy_ms!r}")
    if report.n_rolled_back == 0:
        fail("the fault script rolled nothing back: recovery not exercised")

    # the same admission on the plain version gives the same timeline
    plain_state = make_policy("batched", k=ONLINE_K, scorer="kernel",
                              device="cpu").run(machine, workload)
    if placements(plain_state.schedule) != admitted:
        fail("kernel-scored admission on the card places differently from "
             "the plain version")
    print(f"admission: {len(admitted)} placements equal to device='cpu'")

    # sched_score against its plain version: the path's shapes, a ragged
    # stress shape, +-inf, and NaN propagated at the same places
    rng = np.random.default_rng(0)

    def score_args(a, c, special):
        d = rng.uniform(0.0, 500.0, (a, c)).astype(np.float32)
        f = rng.uniform(0.0, 1e3, c).astype(np.float32)
        r = rng.uniform(0.0, 1e3, a).astype(np.float32)
        if special:                 # +-inf that sum to no NaN
            f[rng.random(c) < 0.1] = np.inf
            r[rng.random(a) < 0.1] = -np.inf
            d[rng.random((a, c)) < 0.02] = np.inf
        if special == "nan":        # NaN in, and inf + -inf
            f[rng.random(c) < 0.05] = np.nan
            d[rng.random((a, c)) < 0.02] = np.nan
            d[rng.random((a, c)) < 0.02] = -np.inf
        return [torch.from_numpy(x).to(dev) for x in (d, f, r)]

    cases = [(f"path{k}", args) for k, (args, _) in score_spy.calls.items()]
    cases += [("stress(1000, 777)", score_args(1000, 777, False)),
              ("inf(1000, 777)", score_args(1000, 777, True)),
              ("nan(1000, 777)", score_args(1000, 777, "nan"))]
    score_err = 0.0
    for name, args in cases:
        got = ops.sched_score(*args)
        want = sched_score_torch(*args)
        torch.cuda.synchronize()
        if name.startswith("nan"):
            if not same_scores(got, want):
                fail(f"sched_score {name}: kernel != plain version")
            continue
        if not torch.equal(got, want):
            fail(f"sched_score {name}: kernel != plain version")
        score_err = max(score_err, (got - want).abs().max().item())
    score_rows = []
    for (dshape, _, _), (args, _) in score_spy.calls.items():
        a, c = dshape
        t_bytes = 4 * (2 * a * c + a + c) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * a * c / FP32_OPS_PER_S * 1e3
        score_rows.append(dict(
            name=f"online({a}, {c})", A=a, C=c,
            ms=cuda_ms(lambda: sched_score_cuda(*args), 200),
            plain_ms=cuda_ms(lambda: sched_score_torch(*args), 200),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=4 * (2 * a * c + a + c)))
        print("sched_score " + json.dumps(score_rows[-1]))

    # sim_relax_pop at the GA's merged-cluster shapes
    for (pshape, *_), (args, kwargs) in relax_spy.calls.items():
        b, s, p1 = pshape
        row = sim_row(f"ga({b}, {s}, {p1})", args, kwargs["n_steps"], ops,
                      sim_relax_pop_cuda, sim_relax_pop_torch)
        kernel_rows.append(row)
        print("sim_relax_pop " + json.dumps(row))

    # the GA's first population: card fitness vs float64
    (graph, mach, pop), kw = fit_spy.calls["first"]
    kw = {k: v for k, v in kw.items() if k != "backend"}
    f_card = ga.population_fitness(graph, mach, pop, backend="cuda", **kw)
    f_f64 = ga.population_fitness(graph, mach, pop, backend="numpy", **kw)
    fit_err = float(np.max(np.abs(f_card - f_f64) / np.abs(f_f64)))
    if not np.allclose(f_card, f_f64, rtol=RTOL_F32, atol=0.0):
        fail(f"GA fitness on the card vs float64: rel err {fit_err:.3e}")
    print(f"ga first population: B={len(pop)} subtasks={graph.n_subtasks} "
          f"fitness rel err vs f64 {fit_err:.3e}")

    main_row = max(kernel_rows, key=lambda x: x["bytes"])
    score_row = max(score_rows, key=lambda x: x["bytes"])
    print(json.dumps({"kernels": [dict(
        name="sim_relax_pop", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_relax_pop.cu",
        replaces="src/repro/kernels/sim_step.py:184",
        launches=launches["sim_relax_pop"]
        + online_launches["sim_relax_pop"],
        launches_by_path={"offline": launches["sim_relax_pop"],
                          "online": online_launches["sim_relax_pop"]},
        max_abs_err=max(x["max_abs_err"] for x in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"]), dict(
        name="sched_score", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_score.cu",
        replaces="src/repro/kernels/sched_score.py:47",
        launches=online_launches["sched_score"],
        launches_by_path={"offline": launches["sched_score"],
                          "online": online_launches["sched_score"]},
        max_abs_err=score_err, ms=score_row["ms"],
        plain_ms=score_row["plain_ms"], bound_ms=score_row["bound_ms"],
        bound_by=score_row["bound_by"], library_ms=None,
        shape=score_row["name"])]}))

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
