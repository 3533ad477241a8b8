"""Time ``flash_decode``, the dense ``sim_relax``, ``sched_score``, the
bf16 ``flash_attention_bwd``, ``rmsnorm_bwd``, ``ssd_scan_bwd`` and AdamW with
the kernels of one checkout of this repository, so that a parent and a
change can be compared on one card in one call (run the probe once per
tree, in turns: parent, change, change, parent).

    python3 tools/kernel_probe.py [--tree DIR] [--label NAME]
                                  [--kernels NAME ...]

``--tree`` is the checkout whose ``src`` is timed (default: this one);
the timing code is this checkout's ``chip_smoke.py``, the same for every
tree. ``--kernels`` picks what to time (default: all). Measured, on one
CUDA device:

- ``flash_decode``, bf16, random q and cache from seed 0, ``pos`` at the
  last slot (a wrapped ring for the local layers), at the serving paths'
  shapes: gemma2-2b run A (q (4, 8, 256), cache (4, 544, 4, 256)), run B
  (1, 4624) and its local layers' 4,096-slot ring, softcap 50, and
  zamba2-7b run D (q (2, 32, 224), cache (2, 716, 32, 224)), no softcap;
  run B's shape also at ``pos`` 0, where one slot is valid (the launches'
  fixed cost).
  ``chip_smoke.decode_row``: device ms from a CUDA graph of 50 calls over
  copies of the cache that hold 3x the L2, the plain version's the same
  way, back-to-back ms on one cache; without a softcap also
  ``scaled_dot_product_attention`` (run B's shape is timed both ways);
  ``sha256``, the first 16 hex digits of a digest of the bits of one
  default call's output (the same inputs in every process, so two trees
  whose digests agree give the same bits).
- ``sim_relax`` at the four offline shapes of ``chip_smoke.py`` phase 2
  (``dense_lags`` of the lowered 64- and 256-core suites, jitter 0 and
  0.01 x 16): ms of one call from CUDA events over 5 calls after 2
  warm-ups, and whether it equals the plain version bit for bit.
- ``sched_score`` on ``chip_smoke.py``'s online path (64 bursty arrivals
  on 256 cores admitted by ``make_policy("batched", k=16,
  scorer="kernel")``): at each shape the path launched, the tree's
  kernel as the path launches it (with the row minimum where the tree's
  launcher takes ``row_min``) timed from a CUDA graph over input copies
  past 3x the L2, an empty kernel on its grid the same way where the
  tree has one (the launch floor), the wrapper's back-to-back ms;
  ``kernel_scores``' host ms per batch after ``drain_matrix``
  (``chip_smoke.kernel_scores_host_ms``: the drain matrix computed
  beforehand, the frontiers frozen), the host ms of one
  ``ClusterState.frontiers()`` on the admitted state (what the live path
  adds to each batch, the same code in both trees), the placements'
  count.
- ``flash_attention_bwd``, bf16, random q, k, v, dout from seed 0 and
  ``out``, ``lse`` from the tree's forward kernel, at ``BWD_SHAPES``:
  gemma2-2b's training layer (2, 1024, 8/4, 256), softcap 50, causal,
  also with its local layers' window 4,096; paligemma-3b's (1, 1024,
  8/1, 256) with a 256-token prefix; hubert-xlarge's (2, 1000, 16, 80)
  bidirectional; an MLA shape (1, 1024, 16, 192/128), causal.
  ``chip_smoke.attention_bwd_row``: the kernels' device ms from a CUDA
  graph over input copies past 3x the L2, the plain version's, SDPA's
  autograd backward where there is no softcap, the bound; beside them
  the share of the bound, the largest error over the bf16 gate's bound
  (``chip_smoke.gate_ratio``; above 1 fails the probe), the tree's
  launch plan (``bwd_plan``, where it has one) and the device ms of
  each kernel of one call (``torch.profiler`` over 5 calls).
- ``rmsnorm_bwd``, bf16 x, w and dy from seed 0 (w' given, as the model
  passes it), at ``NORM_BWD_SHAPES``: the seven widths the training
  paths launch at their (B, S). ``chip_smoke.norm_bwd_row``: the
  kernels' device ms from a CUDA graph over input copies past 3x the
  L2, the plain version's, ``F.rms_norm``'s autograd backward, the
  bound; the share of the bound, the largest error over the gate's bound
  of dx and dw, the tree's launch plan (``bwd_plan``, where it has one)
  and the device ms of the row pass and of the column pass of one call.
- ``adamw``: the tree's ``apply_updates`` over deepseek-v2-lite-16b's
  (6 layers) and zamba2-7b's (39 layers) parameters at full size, as
  the benchmark's cells hold them (``probe_adamw``): device ms a call,
  the host's ms, the device operations a call launches, the memory it
  allocates beyond the state; with the tree's multi-tensor kernels also
  their ms alone, the plain versions', the bound and the counters.
- ``ssd_scan_bwd`` (a tree that has it), bf16 and float32, Mamba-2-like
  inputs from seed 0 (A in -[1, 16], dt log-uniform in [1e-3, 1e-1]) at
  mamba2-780m's and zamba2-7b's training shapes (2, 1024, 48 or 112
  heads of 64, state 128 or 64, chunk 256): ``chip_smoke.ssd_bwd_row``
  (graph ms, plain ms, bound, each gradient's error over the gate's
  bound) and the device ms of each pass of one call.

Prints the card's name and power limit, then the results as one JSON
line (the last).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNELS = ("flash_decode", "sim_relax", "sched_score", "flash_attention_bwd",
           "rmsnorm_bwd", "ssd_scan_bwd", "adamw")
ADAMW_MODELS = (     # the benchmark cells' models: name, arch, config changes
    ("deepseek", "deepseek-v2-lite-16b", dict(n_layers=6, dtype="bfloat16")),
    ("zamba2", "zamba2-7b", dict(n_layers=39, ssm_ngroups=2,
                                 activation="geglu", dtype="bfloat16")),
)
BWD_SHAPES = (      # name, b, s, hq, hkv, d, dv, options (bf16)
    ("gemma2", 2, 1024, 8, 4, 256, 256, dict(softcap=50.0)),
    ("gemma2_window", 2, 1024, 8, 4, 256, 256,
     dict(softcap=50.0, window=4096)),
    ("paligemma", 1, 1024, 8, 1, 256, 256, dict(prefix=256)),
    ("hubert", 2, 1000, 16, 16, 80, 80, dict(causal=False)),
    ("mla", 1, 1024, 16, 16, 192, 128, {}),
)
NORM_BWD_SHAPES = (  # name, (B, S, d): every width the training paths launch
    ("gemma2", (2, 1024, 2304)), ("paligemma", (1, 1024, 2048)),
    ("hubert", (2, 1000, 1280)), ("mamba2", (2, 1024, 1536)),
    ("mamba2_inner", (2, 1024, 3072)), ("zamba2", (2, 1024, 3584)),
    ("zamba2_inner", (2, 1024, 7168)),
)
SCAN_BWD_SHAPES = (  # name, b, s, h, p, g, n, chunk
    ("mamba2", 2, 1024, 48, 64, 1, 128, 256),
    ("zamba2", 2, 1024, 112, 64, 1, 64, 256),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                 # puts this tree's src first
    sys.path.insert(0, str(tree / "src"))   # the timed tree's, before it

    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build
    if Path(repro_torch.__file__).resolve().parents[1] != tree / "src":
        print(f"kernel_probe: imported {repro_torch.__file__}, not the "
              f"tree's", file=sys.stderr)
        return 1

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi)
    sources = {"flash_decode": ["flash_decode"],
               "sim_relax": ["sim_step", "sim_relax_pop"],
               "sched_score": ["sched_score"],
               "flash_attention_bwd": ["flash_attention",
                                       "flash_attention_bwd"],
               "rmsnorm_bwd": ["rmsnorm"], "ssd_scan_bwd": ["ssd_scan"],
               "adamw": [p.stem for p in build.CSRC.glob("adamw.cu")]}
    build.build([src for k in args.kernels for src in sources[k]])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(label=args.label, tree=str(tree), device=smi)
    if "flash_decode" in args.kernels:
        out["flash_decode"] = probe_decode(cs, dev)
    if "sim_relax" in args.kernels:
        out["sim_relax"] = probe_relax(cs, dev)
    if "sched_score" in args.kernels:
        out["sched_score"] = probe_score(cs, dev)
    if "flash_attention_bwd" in args.kernels:
        out["flash_attention_bwd"] = probe_attention_bwd(cs, dev)
    if "rmsnorm_bwd" in args.kernels:
        out["rmsnorm_bwd"] = probe_rmsnorm_bwd(cs, dev)
    if "ssd_scan_bwd" in args.kernels:
        out["ssd_scan_bwd"] = probe_ssd_scan_bwd(cs, dev)
    if "adamw" in args.kernels:
        out["adamw"] = probe_adamw(cs, dev)
    print(json.dumps(out))
    ok = all(r["equal"] for r in out.get("sim_relax", {}).values()) \
        and all(r["gate_ratio"] <= 1.0
                for k in ("flash_attention_bwd", "rmsnorm_bwd")
                for r in out.get(k, {}).values()) \
        and all(max(r["gate_ratios"].values()) <= 1.0
                for r in out.get("ssd_scan_bwd", {}).values())
    return 0 if ok else 1


def probe_decode(cs, dev):
    import torch

    from repro_torch.kernels.flash_decode import flash_decode_cuda
    gen = torch.Generator(device=dev).manual_seed(0)
    decode = {}
    for name, b, t, hq, hkv, d, ring, cap, p in (
            ("gemma2_A", 4, 544, 8, 4, 256, False, 50.0, 543),
            ("gemma2_B", 1, 4624, 8, 4, 256, False, 50.0, 4623),
            ("gemma2_B_ring", 1, 4096, 8, 4, 256, True, 50.0, 4623),
            ("gemma2_B_pos0", 1, 4624, 8, 4, 256, False, 50.0, 0),
            ("zamba2_D", 2, 716, 32, 32, 224, False, None, 715)):
        q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn((b, t, hkv, d), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        kw = dict(ring=ring, softcap=cap, scale=d ** -0.5)
        decode[name] = cs.decode_row(q, kc, vc, pos, kw)
        bits = flash_decode_cuda(q, kc, vc, pos, **kw).view(torch.int16)
        decode[name]["sha256"] = hashlib.sha256(
            bits.cpu().numpy().tobytes()).hexdigest()[:16]
        if name == "gemma2_B":
            decode["gemma2_B_no_softcap"] = cs.decode_row(
                q, kc, vc, pos, dict(kw, softcap=None))
        del q, kc, vc
    for row in decode.values():
        row.pop("args")
    torch.cuda.empty_cache()
    return decode


def probe_relax(cs, dev):
    import torch
    from repro_torch.core import (SynthParams, batch_scenarios,
                                  cluster_of_multicores, generate_app,
                                  get_scheduler, hp_bl260c, lower_scenario,
                                  paper_suite_64core)
    from repro_torch.core.sim_engine import _jitter_durations
    from repro_torch.kernels.sim_step import sim_relax_cuda, sim_relax_torch
    mapper = get_scheduler("engine")
    relax = {}
    for suite, machine, graphs in (
            ("64core", hp_bl260c(), paper_suite_64core(n_apps=10, seed=100)),
            ("256core", cluster_of_multicores(32),
             [generate_app(SynthParams(n_tasks=(240, 280)), seed=300 + i)
              for i in range(4)])):
        schedules = [mapper(g, machine) for g in graphs]
        for tag, jitter, draws in (("plain", 0.0, 1),
                                   ("jitter", cs.JITTER, cs.DRAWS)):
            gs, ss = graphs * draws, schedules * draws
            batch = batch_scenarios([lower_scenario(g, machine, sc)
                                     for g, sc in zip(gs, ss)])
            dur = _jitter_durations(batch, jitter, list(range(len(gs))))
            dargs, host_ms = cs.dense_args(batch, dur, dev)
            depth = batch.depth
            got = sim_relax_cuda(*dargs, n_steps=depth)
            want = sim_relax_torch(*dargs, n_steps=depth)
            torch.cuda.synchronize()
            relax[f"{suite}-{tag}"] = dict(
                B=batch.n_scenarios, S=batch.max_subtasks, depth=depth,
                ms=cs.cuda_ms(lambda: sim_relax_cuda(*dargs, n_steps=depth),
                              5),
                equal=bool(torch.equal(got, want)),
                bound_ms=cs.dense_bounds(batch.n_scenarios,
                                         batch.max_subtasks, depth)[0])
            del dargs, got, want
            torch.cuda.empty_cache()
    return relax


def probe_score(cs, dev):
    import contextlib
    import inspect
    import itertools
    import statistics
    import time

    import torch
    from repro_torch.core import cluster_of_multicores
    from repro_torch.kernels import ops
    from repro_torch.kernels import sched_score as ss
    from repro_torch.online import (ArrivalParams, BatchedPolicy,
                                    generate_workload, make_policy)
    machine = cluster_of_multicores(n_blades=cs.ONLINE_BLADES)
    workload = generate_workload(
        ArrivalParams(rate=0.9 * machine.n_cores / cs.MEAN_APP_WORK_S,
                      process="bursty"), n_apps=cs.ONLINE_APPS, seed=3)
    with contextlib.ExitStack() as stack:
        spy = stack.enter_context(cs.Spy(ops, "sched_score", cs.shapes))
        calls = stack.enter_context(cs.Timed(
            BatchedPolicy, "order_batch",
            keep=lambda pol, batch, eng, now: (pol, list(batch),
                                               cs.FrozenEngine(eng), now)))
        state = make_policy("batched", k=cs.ONLINE_K, scorer="kernel",
                            device=dev).run(machine, workload)
    kw = {"row_min": True} if "row_min" in inspect.signature(
        ss.sched_score_cuda).parameters else {}
    rows = {}
    for (dshape, _, _), (args, _) in spy.calls.items():
        a, c = dshape
        n = -(-3 * cs.L2_BYTES // (4 * (a * c + a + c)))
        copies = [args] + [[x.clone() for x in args] for _ in range(n - 1)]
        turn = itertools.count()

        def kernel():
            return ss.sched_score_cuda(*copies[next(turn) % n], **kw)
        floor = getattr(ss, "empty_cuda", None)
        rows[str(dshape)] = dict(
            ms=cs.graph_ms(kernel, n),
            floor_ms=None if floor is None
            else cs.graph_ms(lambda: floor(a, dev), n),
            eager_ms=cs.cuda_ms(lambda: ss.sched_score_cuda(*args, **kw),
                                200),
            row_min=bool(kw), copies=n)
        del copies
        torch.cuda.empty_cache()
    host = cs.kernel_scores_host_ms(
        [c for c in calls.kept if c[0].scorer == "kernel"])
    frontiers = []
    for _ in range(50):
        t0 = time.perf_counter()
        state.frontiers()
        frontiers.append((time.perf_counter() - t0) * 1e3)
    return dict(shapes=rows, kernel_scores_host_ms=host,
                frontiers_ms=statistics.median(frontiers),
                placements=len(state.schedule.placements))


def launch_split(fn, n=5):
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``n`` calls (names cut to 60 characters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us and "CUDA" in str(getattr(e, "device_type", "")):
            split[e.key[:60]] = us / 1e3 / n
    return split


def probe_attention_bwd(cs, dev):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, b, s, hq, hkv, d, dv, opts in BWD_SHAPES:
        q, k, v, dout = (torch.randn(shape, generator=gen,
                                     device=dev).bfloat16()
                         for shape in ((b, s, hq, d), (b, s, hkv, d),
                                       (b, s, hkv, dv), (b, s, hq, dv)))
        kw = dict(causal=opts.get("causal", True), scale=d ** -0.5,
                  window=opts.get("window"), softcap=opts.get("softcap"))
        if "prefix" in opts:
            kw["prefix_len"] = torch.full((b,), opts["prefix"],
                                          dtype=torch.int32, device=dev)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        args = (q, k, v, out, dout, lse)
        got = fa.flash_attention_bwd_cuda(*args, **kw)
        want = fa.flash_attention_bwd_torch(*args, **kw)
        row = cs.attention_bwd_row(args, kw)
        row["gate_ratio"] = max(cs.gate_ratio(g, w)
                                for g, w in zip(got, want))
        row["kernels_ms"] = launch_split(
            lambda: fa.flash_attention_bwd_cuda(*args, **kw))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        del q, k, v, dout, out, lse, args, got, want
        torch.cuda.empty_cache()
    return rows


def probe_rmsnorm_bwd(cs, dev):
    import torch
    from repro_torch.kernels import rmsnorm
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    kw = dict(zero_centered=False)
    for name, shape in NORM_BWD_SHAPES:
        x, dy = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        w = (1.0 + 0.1 * torch.randn(shape[-1:], generator=gen,
                                     device=dev)).bfloat16()
        got = rmsnorm.rmsnorm_bwd_cuda(x, w, dy, **kw)
        want = rmsnorm.rmsnorm_bwd_torch(x, w, dy, **kw)
        row = cs.norm_bwd_row(x, w, dy, kw)
        row["gate_ratio"] = max(cs.gate_ratio(g, w_)
                                for g, w_ in zip(got, want))
        row["kernels_ms"] = launch_split(
            lambda: rmsnorm.rmsnorm_bwd_cuda(x, w, dy, **kw))
        rows[name] = row
        del x, dy, got, want
        torch.cuda.empty_cache()
    return rows


def probe_ssd_scan_bwd(cs, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_scan
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, h, p, g, n, chunk in SCAN_BWD_SHAPES:
            rng = np.random.default_rng(0)
            arrays = (rng.standard_normal((b, s, h, p)),
                      np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                         (b, s, h))),
                      -rng.uniform(1.0, 16.0, h),
                      rng.standard_normal((b, s, g, n)) * 0.5,
                      rng.standard_normal((b, s, g, n)) * 0.5,
                      rng.standard_normal((b, s, h, p)))
            x, dt, A, B, C, dy = (
                torch.from_numpy(a).to(dev, torch.float32 if i in (1, 2)
                                       else dtype)
                for i, a in enumerate(arrays))
            args = (x, dt, A, B, C, dy, None, chunk)
            row = cs.ssd_bwd_row(args)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["kernels_ms"] = launch_split(
                lambda: ssd_scan.ssd_scan_bwd_cuda(*args))
            rows[f"{name}_{str(dtype)[6:]}"] = row
            del x, dt, A, B, C, dy, args
            torch.cuda.empty_cache()
    return rows


def probe_adamw(cs, dev):
    """The tree's ``apply_updates`` over each benchmark model's parameters
    at full size (bf16 and float32 leaves as the model has them, float32
    moments, gradients N(0, 1e-2²) of the parameter's type, step 3):
    device ms a call from CUDA events over 3 calls after 2 warm-ups, the
    host ms of a call (its return, no synchronise), the device operations
    one call launches (``torch.profiler``: kernels and copies; the call
    alone, the step counter set before it) and the
    host operations that took most of the host's time in it, and the
    bytes it allocates beyond the state at its peak. Where the tree has
    the multi-tensor kernels, also the kernels alone (``grad_sumsq`` then
    ``adamw_update``), the plain versions, the library's calls
    (``torch._foreach_norm`` in float32, ``torch._fused_adamw_``; what it
    raises where it refuses the lists), the counters a call adds, and
    the bound: each byte the update and the norm need, once, at 3.35
    TB/s (the update's 22 B a bf16 parameter, 28 a float32 one, and the
    gradient again for the norm: 24 and 32 B)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    fused = hasattr(ops, "adamw_update")
    rows = {}
    for name, arch, changes in ADAMW_MODELS:
        cfg = ARCHS[arch].replace(**changes)
        model = init_params(cfg, torch.Generator(), "meta")
        specs = {k: (p.shape, p.dtype) for k, p in model.named_parameters()}
        del model
        gen = torch.Generator(device=dev).manual_seed(0)
        params = {k: torch.randn(s, generator=gen, device=dev).to(dt)
                  for k, (s, dt) in specs.items()}
        grads = {k: (torch.randn(s, generator=gen, device=dev) * 1e-2).to(dt)
                 for k, (s, dt) in specs.items()}
        opt = OptConfig()
        state = init_opt_state(params, opt)
        state["step"].fill_(2)
        row = dict(tensors=len(specs),
                   parameters=sum(p.numel() for p in params.values()))
        need = sum(p.numel() * (4 * p.element_size() + 16)
                   for p in params.values())
        row["bound_ms"] = need / 3.35e12 * 1e3

        def step():
            state["step"].fill_(2)
            apply_updates(params, grads, state, opt)
        row["apply_updates_ms"] = cs.cuda_ms(step, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        row["apply_updates_host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts = (ops.grad_sumsq.launches, ops.adamw_update.launches,
                  ops.adamw_update.tensors) if fused else None
        state["step"].fill_(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            apply_updates(params, grads, state, opt)
            torch.cuda.synchronize()
        row["extra_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        events = prof.key_averages()
        row["device_ops"] = sum(
            e.count for e in events
            if "CUDA" in str(getattr(e, "device_type", "")))
        host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                       for e in events if e.self_cpu_time_total > 0),
                      reverse=True)[:8]
        row["host_ops_ms"] = [[k[:40], round(ms, 3), n] for ms, k, n in host]
        if fused:
            from repro_torch.kernels import adamw
            row["counters"] = dict(zip(
                ("grad_sumsq_launches", "adamw_update_launches",
                 "adamw_update_tensors"),
                (ops.grad_sumsq.launches - counts[0],
                 ops.adamw_update.launches - counts[1],
                 ops.adamw_update.tensors - counts[2])))
            lists = [list(params.values()), list(grads.values()),
                     list(state["m"].values()), list(state["v"].values())]
            scalars = dict(clip=torch.tensor(0.5, device=dev),
                           lr=torch.tensor(1e-4, device=dev),
                           b1c=torch.tensor(0.271, device=dev),
                           b2c=torch.tensor(0.142625, device=dev))
            consts = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                          weight_decay=opt.weight_decay)
            row["grad_sumsq_ms"] = cs.cuda_ms(
                lambda: ops.grad_sumsq(lists[1]), 3)
            row["adamw_update_ms"] = cs.cuda_ms(
                lambda: ops.adamw_update(*lists, **scalars, **consts), 3)
            row["plain_ms"] = cs.cuda_ms(
                lambda: (adamw.grad_sumsq_torch(lists[1]),
                         adamw.adamw_update_torch(*lists, **scalars,
                                                  **consts)), 1)
            row["kernels_ms"] = row["grad_sumsq_ms"] + row["adamw_update_ms"]
            steps = [torch.ones((), device=dev) for _ in lists[0]]
            library = {
                "grad_sumsq": lambda: torch._foreach_norm(
                    lists[1], 2, dtype=torch.float32),
                "adamw_update": lambda: torch._fused_adamw_(
                    *lists, [], steps, lr=1e-4, beta1=opt.b1, beta2=opt.b2,
                    weight_decay=opt.weight_decay, eps=opt.eps,
                    amsgrad=False, maximize=False)}
            for k, fn in library.items():
                try:
                    row[f"{k}_library_ms"] = cs.cuda_ms(fn, 3)
                except (RuntimeError, TypeError) as e:
                    row[f"{k}_library_ms"] = None
                    row[f"{k}_library_error"] = \
                        str(e).strip().splitlines()[0][:200]
            row["bound_share"] = row["bound_ms"] / row["kernels_ms"]
            del lists
        rows[name] = row
        del params, grads, state
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
