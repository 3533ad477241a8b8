#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root (it puts ``src`` on ``sys.path`` itself):

    python3 chip_smoke.py

1. Builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
   and prints nvcc's register/spill report and the count of ``HGMMA``
   (wgmma) instructions in each library's SASS (``cuobjdump -sass``).
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
   tensors at every main-path shape, and the sweeps each row ran equal to
   the plain stop's (``fixpoint_sweeps_torch``); a non-zero launch count.
4. Numbers: per shape, the kernel's time from CUDA events, the plain
   version's, the bound (from the inputs alone: read once, or one
   topological pass of operations) and what bounds it, the launch plan
   (cluster size k, staged or L2 variant) and the sweeps the rows ran
   before their fixpoint (max, median) against ``n_steps``; a host-side
   breakdown of ``simulate_batch``.
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
   (the fused kernel: the matrix and each row's minimum in one launch)
   equal to its plain version under ``torch.equal``, the matrix and the
   minima, at every shape the path launched, at a ragged stress shape
   (scalar loads; the path's C = 256 takes 16-byte loads) and with
   +-inf, and with NaN propagated at the same places; ``sim_relax_pop``
   equal to its plain version at the GA's shapes; the GA's first
   population's fitness on the card within rtol 1e-5 of float64; both
   kernels launched; the GA-refined makespan at most that of the greedy
   re-map it starts from (losing a core may lengthen the plan, the GA
   must not); ``validate()`` after admission and after recovery.
   Numbers: kernel/plain/bound ms and launches (``sched_score``'s device
   ms from a CUDA graph over input copies past the L2, beside an empty
   kernel's on its grid, the launch floor), ``kernel_scores``' host ms
   per batch after ``drain_matrix`` (replayed on each batch's frozen
   inputs), admission/evaluate/recovery wall seconds with a host
   breakdown of their layers, the recovery report.
6. Serving path: gemma2-2b at full width and depth in bf16, weights from
   ``init_params`` with a CUDA generator seeded 0 and every norm scale
   redrawn N(0, 0.1) from it. Run A: ``generate`` at B=4, prompt 512, 32
   new tokens; run B: B=1, prompt 4608 (past the 4096 window, so the
   local layers' ring caches wrap), 16 new tokens; run C:
   ``ContinuousBatcher(n_slots=4, max_seq=1024)`` over 8 requests with
   prompts of 37-700 tokens and 8-24 new tokens each. The three serving
   kernels' counts are zeroed before each run and read after it. Checks:
   the counts equal what the path implies (rmsnorm 4 per layer + 1 per
   forward, flash_attention one per layer per prefill, flash_decode one
   per layer per decode step); each kernel within tolerance of its plain
   version (``close_to_plain``) at every shape the path launched and a
   ragged stress shape; run A teacher-forced, the kernel path's logits
   within 5e-2 of the largest logit of the same model on the card with
   the three entry points swapped for their plain versions, at the
   prefill and every decode step; run C's requests equal to
   ``generate`` of each alone, token for token. Numbers: per run prefill
   ms, decode ms per step, tokens/s; per kernel at its largest path
   shape the kernel's, plain version's and library call's ms and the
   bound, ``flash_attention`` (the bf16 tensor-core kernel) also with
   TFLOP/s against the bound's operation count; ``rmsnorm`` against
   ``F.rms_norm`` at every prefill width and ``flash_decode`` (and, with
   no softcap, ``scaled_dot_product_attention``) at its largest path
   shape, device ms from a CUDA graph over input copies past the L2,
   back-to-back ms beside them; ``flash_decode`` also bitwise equal
   across two launches at every path shape; side rows without softcap
   against ``scaled_dot_product_attention``;
   where one decode step's time goes (host parts, the profiler's device
   time and top kernels).
7. SSM and hybrid serving: mamba2-780m (48 layers, d 1536, 48 heads of
   64, state 128, chunk 256) and zamba2-7b (81 Mamba-2 layers in 13 groups
   of 6 plus 3, a shared attention block on 7168 wide at the head of each
   group with a rank-128 LoRA per group) at full width and depth in bf16,
   weights from ``init_params`` with a CUDA generator seeded 0, the norm
   scales redrawn N(0, 0.1), Mamba-2's A in -[1, 16] and dt log-uniform
   in [1e-3, 1e-1] (the reference's init makes every chunk's decay
   underflow, which would hide the state carried across chunks) and the
   LoRA ``b_*`` redrawn non-zero. mamba2 run A: ``generate``, B=4, prompt
   512, 32 new tokens; run B: B=1, prompt 4000 (15 chunks and a ragged
   160), 16 new tokens; run C: the batcher over run C's 8 ragged
   requests. zamba2 run D: ``generate``, B=2, prompt 700, 16 new tokens.
   The four serving kernels' counts are zeroed before each run and read
   after it. Checks: exact counts (rmsnorm 2 per Mamba layer, 2 per
   shared-block use and 1 final per forward; ssd_scan one per Mamba layer
   per prefill; flash_attention and flash_decode one per group per
   prefill and per decode step); each kernel within ``close_to_plain`` of
   its plain version at every path shape (prompts under one chunk and
   ragged ones among them) and a stress shape; run A's teacher-forced
   logits against the plain path, in float32 within 1e-4 of the largest
   logit and in bf16 no further from the float32 logits than 2x the
   plain path is, a gate that must fail the kernel path with a planted
   fault in ``ssd_scan`` (the carry between chunks dropped); run C equal
   to ``generate`` alone. Numbers: per run prefill ms, decode ms per
   step, tokens/s; ssd_scan's kernel, plain and bound ms and its error
   over the 2-ulp gate's bound at every path shape, and the device ms of
   each of its passes at the largest; ``rmsnorm`` at every prefill width
   (1536, 3072, 3584, 7168) against ``F.rms_norm``; ``flash_attention``
   at zamba2's (2, 700, 32, 224) against causal
   ``scaled_dot_product_attention``, which computes the same function
   there (no softcap, no window); the bf16 gate's reading with each
   planted fault; a decode step's profile per model.
8. Dense path, on the four shapes of phase 2: ``lint_batch`` ->
   ``dense_lags`` -> ``ops.sim_relax(n_steps=depth)`` (the hand-written
   ``sim_step`` kernels: the lags compacted on the card, then
   ``sim_relax_pop`` stopped at each row's fixpoint), its counts (calls
   and variants) zeroed just before and read just after. Checks: the
   compact variant gave every shape and ``ops.sim_relax_pop``'s count
   did not move; ``torch.equal`` to ``sim_relax_torch`` at every shape,
   within rtol 1e-5 of the float64 ``relax_batch_np`` and of phase 2's
   sparse results; the compaction equal to ``compact_lags_torch`` and
   each row's sweeps equal to ``fixpoint_sweeps_torch``'s on the compact
   form; the dense variant alone equal to the plain version;
   ``ops.sim_step`` equal to its plain version at ragged stress shapes
   (S = 37 and 1000) with -inf, and with NaN at the same places;
   ``ops.sim_relax`` at S = 256 and 257 on a clean scenario (compact),
   NaN lags and an +inf duration (dense) and ends that overflow
   (compact, redone dense), equal to the plain version with NaN at the
   same places and both variant counts moved. Numbers: the call's ms,
   the compaction's and the stopped relaxation's, the dense variant's,
   one sweep's, the plain ms, P+1, the sweeps (max, median), the call
   bound (inputs once) and the streaming bound (every sweep), host ms of
   ``dense_lags``.
9. Device GA: ``ga_search`` with ``GAParams(device=True)`` at the
   defaults (pop 32, 24 generations, refine 3 x 48) on the largest app
   of the 64-core suite and on a 240-280-task app on 256 cores, twice
   each with seed 0, ``sim_relax_pop``'s count zeroed before each run.
   Checks: the same winner and fitness; launches = 1 + generations +
   the refine rounds run; the final population's kernel fitness equal
   to the scan's under ``torch.equal``; the winner's fitness within
   rtol 1e-5 of its float64 append-only decode; ``ga_schedule`` with
   the device GA valid and never worse than ``engine``. Numbers: search
   wall seconds, ms per generation, the host GA's seconds at the same
   budget, ``sim_relax_pop``'s kernel, plain and bound ms, plan and
   sweeps run against ``n_steps = S`` at the GA's shapes (the kernels
   line reports the larger of the two).
10. Verify: ``simulate_suite(..., verify=True)`` on the 64-core suites
   (the kernel) and ``get_scheduler("engine", verify=True)``; a result
   with one finish time moved before its predecessor's must raise
   ``VerifyError``.
11. Analysis: the port's lint (``repro_torch.analysis.lint``) over its
   package, tests, this script and ``tools/``, and its tracecheck
   (``repro_torch.analysis.tracecheck``, ``--quick``) on the card over
   the manifest; any finding fails, each entry must launch its kernel
   once per call (``TRACE_LAUNCHES``) and the admission scorer must read
   back exactly once per call.
12. The paper's evaluation: its 8-core suite (20 apps of 15-25 tasks,
   seed 0) on ``dell_poweredge_1950`` and its 64-core suite (8 apps,
   seed 100) on ``hp_bl260c``, mapped by ``get_scheduler("engine")``
   (T_est = makespan). T_exec from the contention-aware event simulator
   (jitter 0.01), ``simulate_suite(backend="cuda")`` (``sim_relax_pop``,
   count zeroed before and read after) and the threaded executor
   (``execute_threaded``, one thread per core, ``time_scale`` 1e-3,
   wall-clock). Checks: every threaded T_exec >= T_est, T_exec ==
   wall_seconds / time_scale, ``dif_rel`` exactly Eq. 4, the batched
   result within rtol 1e-5 of float64, the kernel launched. Numbers: per
   source n, mean, max and min %Dif_rel beside the paper's band (4 % at
   8 cores, 6 % at 64), printed and not gated (the threaded T_exec is
   wall-clock on a shared host); the executor's wall seconds per suite.
13. MoE and MLA serving in bf16, weights from ``init_params`` with a CUDA
   generator seeded 0 and every norm scale (``kv_norm`` too) redrawn
   N(0, 0.1); one model on the card at a time, its peak memory printed.
   deepseek-v2-lite-16b whole (27 layers, d 2048, 16 heads, MLA L 512 /
   nope 128 / rope 64 / v 128, layer 0 dense, 26 MoE layers of 64
   experts top-6 of 1408 plus 2 shared): run A ``generate`` B=4, 512 +
   32; run B B=1, 4096 + 16; run C the batcher over phase 6's requests
   (latent caches padded at each join). qwen3-moe-235b-a22b at full
   width (d 4096, 64/4 heads of 128, qk-norm, 128 experts top-8 of 1536)
   cut from 94 to 8 layers: run A. Checks: exact counts (rmsnorm 2 per
   layer, +1 per MLA layer, +2 per qk-norm layer, +1 per forward;
   flash_attention one per layer per prefill; flash_decode one per
   layer per decode step for qwen3 and none for deepseek, whose absorbed
   MLA decode is plain PyTorch); each kernel within ``close_to_plain``
   at every shape the path launched (MLA's D 192 against Dv 128, qwen3's
   16 q heads per kv head); deepseek run A teacher-forced against the
   plain path with each MoE layer's routes recorded on both (the share
   of (token, layer) routes that differ printed: a rounding difference
   moves a token to other experts, and that token moves every later
   one through attention), and the plain path run again on the kernel
   path's routes, its logits within 5e-2 of the largest at every
   position; the same in float32 on deepseek cut to 4 layers within
   1e-4; run C equal to ``generate`` alone. Numbers:
   per run prefill ms, decode ms per step, tokens/s; ``flash_attention``
   at the runs' prefill shapes beside causal
   ``scaled_dot_product_attention``; ``flash_decode`` at qwen3's shape
   beside it; ``rmsnorm`` at every prefill width; a decode step's
   profile per model beside the bound of reading every weight once.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run outside a checkout. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
L2_BYTES = 50 * 2 ** 20             # H100 SXM L2 cache
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


def graph_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls captured in
    one CUDA graph and replayed, from CUDA events: the kernels' own time
    without the host's dispatch between them, which a back-to-back
    ``cuda_ms`` of a short kernel measures instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def sdpa(q, k, v, mask, causal, scale):
    """``scaled_dot_product_attention`` on the (B, S, H, D) layout: one
    library call, timed beside the kernels and used nowhere in the port.
    GQA natively where this PyTorch has ``enable_gqa``, else K/V
    repeated."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(attn_mask=mask, is_causal=causal and mask is None, scale=scale)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **kw)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, dim=1),
            vt.repeat_interleave(g, dim=1), **kw)
    return out.transpose(1, 2)


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
    the first arguments of each distinct ``key(args)`` (with the values
    of the keyword arguments named in ``kw_names``); every call goes on
    to the real function, whose own count is untouched."""

    def __init__(self, module, name, key, kw_names=()):
        self.module, self.name, self.key = module, name, key
        self.kw_names = kw_names
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
        if self.kw_names:
            k = (k, tuple(kwargs.get(n) for n in self.kw_names))
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
    while it stands in, and keeps ``keep(*args, **kwargs)`` of each call
    where given. The stand-in is a plain function, so a method put on a
    class still binds."""

    def __init__(self, owner, name, keep=None):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.seconds, self.calls = 0.0, 0
        self.keep, self.kept = keep, []

    def __enter__(self):
        fn = self.fn

        def timed(*args, **kwargs):
            if self.keep is not None:
                self.kept.append(self.keep(*args, **kwargs))
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


def score_row(args):
    """``sched_score`` at one path shape: the fused kernel's (matrix and
    row minima, the path's launch) device ms from a CUDA graph of calls
    that take turns over copies of the inputs holding three times the L2,
    so each reads them from device memory as the bound counts it; the
    same for an empty kernel on the kernel's grid (the launch floor); the
    plain version's device ms from a graph of 200 calls (its inputs warm
    in the L2); the back-to-back ms of the kernel's wrapper (ctypes and
    two allocations, what the path pays per launch); the bound and what
    bounds it (inputs once, the matrix and the minima written once; a
    max, an add and a compare per element)."""
    from repro_torch.kernels.sched_score import (empty_cuda,
                                                 sched_score_cuda,
                                                 sched_score_torch)
    drain, f, r = args
    a, c = drain.shape
    n_bytes = 4 * (2 * a * c + a + c + a)
    b_ms, b_by = bound(n_bytes, 3 * a * c, FP32_OPS_PER_S)
    per_call = 4 * (a * c + a + c)
    n = -(-3 * L2_BYTES // per_call)
    copies = [args] + [[x.clone() for x in args] for _ in range(n - 1)]
    turn = itertools.count()

    def kernel():
        return sched_score_cuda(*copies[next(turn) % n], row_min=True)

    def plain():
        return sched_score_torch(*copies[next(turn) % n], row_min=True)

    row = dict(
        name=f"online({a}, {c})", A=a, C=c, ms=graph_ms(kernel, n),
        floor_ms=graph_ms(lambda: empty_cuda(a, drain.device), n),
        plain_ms=graph_ms(plain, 200), bound_ms=b_ms, bound_by=b_by,
        eager_ms=cuda_ms(lambda: sched_score_cuda(*args, row_min=True), 200),
        copies=n, bytes=n_bytes)
    del copies
    return row


class FrozenEngine:
    """What ``BatchedPolicy.kernel_scores`` reads of an ``OnlineAMTHA``
    (its machine and the cluster's frontiers), frozen at one batch so the
    call can be replayed after the admission has moved on."""

    def __init__(self, eng):
        self.machine = eng.machine
        self.state = self
        self._frontiers = list(eng.state.frontiers())

    def frontiers(self):
        return self._frontiers


def kernel_scores_host_ms(calls, reps=200):
    """Host ms per batch of ``kernel_scores`` after ``drain_matrix``: for
    each recorded ``(policy, batch, frozen engine, now)``, the median of
    ``reps`` calls with the batch's drain matrix computed beforehand (the
    policies module's ``drain_matrix`` stands in with it) and the
    frontiers frozen (a list read, where the live engine computes them).
    Each call ends in its read-back, so its time is the host's wait for
    the card too. Returns the per-batch values."""
    import statistics

    from repro_torch.online import policies

    real = policies.drain_matrix
    out = []
    try:
        for policy, batch, eng, now in calls:
            drain = real([a.graph for a in batch], eng.machine)
            policies.drain_matrix = lambda graphs, machine, d=drain: d
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                policy.kernel_scores(batch, eng, now)
                times.append((time.perf_counter() - t0) * 1e3)
            out.append(statistics.median(times))
    finally:
        policies.drain_matrix = real
    return out


def sim_row(name, args, steps, ops, sim_relax_pop_cuda, sim_relax_pop_torch):
    """Kernel vs plain on the same device tensors, times and bound, the
    launch plan (cluster size k, variant) and the sweeps the rows ran
    against ``n_steps``."""
    import torch

    from repro_torch.kernels.sim_step import (fixpoint_sweeps_torch,
                                              pop_plan)
    got = ops.sim_relax_pop(*args, n_steps=steps)
    want = sim_relax_pop_torch(*args, n_steps=steps)
    _, sweeps = sim_relax_pop_cuda(*args, n_steps=steps, with_sweeps=True)
    stopped, want_sweeps = fixpoint_sweeps_torch(*args, n_steps=steps)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: kernel != plain version, max abs err "
             f"{(got - want).abs().max().item():.3e}")
    if not torch.equal(stopped, want):
        fail(f"{name}: the plain stop at the fixpoint != {steps} sweeps")
    if not torch.equal(sweeps, want_sweeps):
        fail(f"{name}: the kernel's sweeps (max {int(sweeps.max())}) != "
             f"the plain stop's (max {int(want_sweeps.max())})")
    b, s, p1 = args[0].shape
    plan = pop_plan(b, s, p1)
    ms = cuda_ms(lambda: sim_relax_pop_cuda(*args, n_steps=steps), 20)
    plain_ms = cuda_ms(lambda: sim_relax_pop_torch(*args, n_steps=steps), 5)
    n_bytes = sum(x.numel() * x.element_size() for x in args) + b * s * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    # from the inputs alone: one pass in topological order (the scan
    # population_ends) gives the result, 3 operations per (b, s, p)
    t_ops = b * s * p1 * 3 / FP32_OPS_PER_S * 1e3
    return dict(name=name, B=b, S=s, P1=p1, depth=steps,
                sweeps_max=int(sweeps.max()),
                sweeps_median=float(sweeps.float().median()),
                k=plan.k, variant=plan.variant,
                shared_bytes=plan.shared_bytes,
                max_abs_err=(got - want).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes)


# -- 6. serving the dense family: gemma2-2b on rmsnorm, flash_attention,
#       flash_decode; 7. the SSM and hybrid families: mamba2-780m and
#       zamba2-7b on ssd_scan and the same three ---------------------------

SERVE_ARCH = "gemma2-2b"
RUN_A = dict(batch=4, prompt=512, gen=32)
RUN_B = dict(batch=1, prompt=4608, gen=16)     # past the 4096 window
RUN_C = dict(n_slots=4, max_seq=1024, n_requests=8, prompt=(37, 700),
             max_new=(8, 24))
SSM_RUN_A = dict(batch=4, prompt=512, gen=32)  # two whole chunks of 256
SSM_RUN_B = dict(batch=1, prompt=4000, gen=16)  # 15 chunks + a ragged 160
SSM_RUN_D = dict(batch=2, prompt=700, gen=16)  # zamba2-7b
SCAN_RUNS = {(4, 512, 48, 64): "mamba2_A", (1, 4000, 48, 64): "mamba2_B",
             (2, 700, 112, 64): "zamba2_D"}   # ssd_scan's bf16 x by run
BF16_OPS_PER_S = 989e12             # H100 SXM dense bf16 tensor-core rate
NORM_STD = 0.1                      # norm scales redrawn N(0, 0.1)
LOGIT_REL = 5e-2                    # teacher-forced logits: check_teacher_forced
F32_LOGIT_REL = 1e-4                # and in float32: check_teacher_forced_f32
BF16_ERR_RATIO = 2.0                # bf16 kernel vs plain path error ratio
GATED_FAULTS = ("dropped carry",)   # planted faults the bf16 gate must fail
SERVE_KERNELS = ("rmsnorm", "flash_attention", "flash_decode")
SSM_KERNELS = SERVE_KERNELS + ("ssd_scan",)


def close_to_plain(got, want):
    """(ok, max abs err). float32: rtol 1e-5 with an absolute floor of
    1e-5 x max|want| (sums in another order; outputs that cancel near
    zero). bfloat16: at most 2 bfloat16 ulps of max(|want|, max|want| /
    256): both versions compute in float32 and round once."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    ok = got.shape == want.shape and got.dtype == want.dtype \
        and bool((err <= plain_bound(want)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def plain_bound(want):
    """``close_to_plain``'s bound on each element's error."""
    import torch
    w = want.double()
    amax = float(w.abs().max()) if w.numel() else 0.0
    if want.dtype == torch.float32:
        return 1e-5 * w.abs() + 1e-5 * amax
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    return 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)


def gate_ratio(got, want):
    """The largest error over ``close_to_plain``'s bound (<= 1 passes)."""
    if not want.numel():
        return 0.0
    err = (got.double() - want.double()).abs()
    return float((err / plain_bound(want)).max())


def visible_pairs(s, causal, window):
    """(query, key) pairs the attention mask lets through."""
    if not causal:
        return s * s if window is None else \
            sum(min(s, i + window) for i in range(s))
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attn_cost(q, k, v, *, causal, window):
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                  + b * s * hq * dv)
    flops = 2 * b * hq * visible_pairs(s, causal, window) * (d + dv)
    return n_bytes, flops


def decode_cost(q, kc, vc, pos, *, ring):
    b, hq, d = q.shape
    t, hkv, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    lim = [min(int(p) + 1, t) if ring else int(p) + 1 for p in pos.tolist()]
    n_bytes = q.element_size() * (q.numel() + sum(lim) * hkv * (d + dv)
                                  + b * hq * dv) + 4 * b
    flops = 2 * hq * sum(lim) * (d + dv)
    return n_bytes, flops


def ssd_cost(x, dt, A, B, C, chunk):
    """Bytes (each input read once, y and the final state written once)
    and the operations the function needs: per chunk of L real
    positions, per batch row and head, C B^T and M x over the L (L + 1)
    / 2 causal (query, key) pairs, 2 L (L + 1) / 2 (N + P), and the
    state's two products, 4 L N P."""
    b, s, h, p = x.shape
    n = B.shape[3]
    n_bytes = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C)) \
        + x.element_size() * (x.numel() + b * h * p * n)
    per_head = sum(ln * (ln + 1) * (n + p) + 4 * ln * n * p
                   for ln in (min(chunk, s - c0) for c0 in range(0, s, chunk)))
    return n_bytes, per_head * b * h


def bound(n_bytes, flops, ops_per_s):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class ModeTimer:
    """Stands in for ``serve_loop.forward`` and adds up the host wall
    seconds of each call by mode, synchronising the card after it so
    that a call's time is its own."""

    def __init__(self, module):
        self.module, self.fn = module, module.forward
        self.seconds, self.calls = {}, {}

    def __call__(self, params, batch, cfg, ctx):
        import torch
        t0 = time.perf_counter()
        out = self.fn(params, batch, cfg, ctx)
        torch.cuda.synchronize()
        self.seconds[ctx.mode] = self.seconds.get(ctx.mode, 0.0) \
            + time.perf_counter() - t0
        self.calls[ctx.mode] = self.calls.get(ctx.mode, 0) + 1
        return out

    def __enter__(self):
        self.module.forward = self
        return self

    def __exit__(self, *exc):
        self.module.forward = self.fn


@contextlib.contextmanager
def swapped(ops, **fns):
    """Entry points of ``ops`` replaced by ``fns`` (same arguments) for
    the span of the block (the package itself has no such switch)."""
    saved = {k: getattr(ops, k) for k in fns}
    for k, fn in fns.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def plain_serving_kernels(ops):
    """The serving entry points replaced by their plain PyTorch versions:
    the same model on the card without the kernels."""
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch
    return swapped(ops, rmsnorm=rmsnorm_torch,
                   flash_attention=flash_attention_torch,
                   flash_decode=flash_decode_torch, ssd_scan=ssd_scan_torch)


def scan_without_carry(x, dt, A, B, C, chunk):
    """A planted fault: the kernel run on each chunk alone, from a zero
    state, so the state carried from chunk to chunk is dropped."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        part = [t[:, c0:c0 + chunk].contiguous() for t in (x, dt, B, C)]
        y, state = ssd_scan_cuda(part[0], part[1], A, part[2], part[3],
                                 chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def scan_rounded_apart(x, dt, A, B, C, chunk):
    """A planted fault: the chunked form's bf16 roundings (M and the
    decay weights cast to x's type before their products, the diagonal
    and off-diagonal parts of y rounded apart), as the reference's
    ``ssd_chunked`` rounds."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk)


def redraw(params, gen, dev):
    """Redraw, from ``gen``, what the reference's init leaves degenerate:
    every norm scale N(0, 0.1); Mamba-2's A in -[1, 16] (``A_log`` = log
    U[1, 16]) and dt log-uniform in [1e-3, 1e-1] (``dt_bias`` =
    softplus^-1 dt), as arXiv:2405.21060 initialises them, so the state
    carried across chunks does not underflow; the shared block's LoRA
    ``b_*`` N(0, 1)/sqrt(r), so the per-slot LoRA adds something. ``D``
    stays 1."""
    import math
    import torch
    lo, hi = math.log(1e-3), math.log(1e-1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "A_log":
                u = torch.rand(p.shape, generator=gen, device=dev)
                p.copy_(torch.log(1.0 + 15.0 * u))
            elif leaf == "dt_bias":
                u = torch.rand(p.shape, generator=gen, device=dev)
                dt = torch.exp(lo + (hi - lo) * u)
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf.startswith("b_"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        / math.sqrt(p.shape[0]))
            elif p.dim() == 1 and leaf != "D":      # every norm scale
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        * NORM_STD)


def ragged_requests(vocab, seed=0):
    """RUN_C's requests: prompts of 37-700 tokens (both ends included),
    8-24 new tokens each."""
    import numpy as np
    from repro_torch.runtime import Request
    rng = np.random.default_rng(seed)
    lo, hi = RUN_C["prompt"]
    lens = [lo, hi] + rng.integers(lo, hi + 1,
                                   RUN_C["n_requests"] - 2).tolist()
    news = rng.integers(RUN_C["max_new"][0], RUN_C["max_new"][1] + 1,
                        RUN_C["n_requests"]).tolist()
    return [Request(rid=i, prompt=rng.integers(0, vocab, n), max_new=m)
            for i, (n, m) in enumerate(zip(lens, news))]


def drive(label, name, run, cfg, params, spies, want, *, prompt=None,
          reqs=None):
    """One run through the entry points a user calls, every spied
    kernel's count zeroed just before it and read just after: ``generate``
    of ``prompt``, or a ``ContinuousBatcher`` over ``reqs``. Fails unless
    the counts equal ``want(prefills, decode_steps)``. Returns the run's
    record and its counts."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import ContinuousBatcher, generate, serve_loop
    for s in spies.values():
        s.launches = 0
    with ModeTimer(serve_loop) as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reqs is not None:
            batcher = ContinuousBatcher(cfg, params, n_slots=run["n_slots"],
                                        max_seq=run["max_seq"])
            for r in reqs:
                batcher.submit(r)
            ticks = batcher.run()
            out = None
            n_tok = sum(len(r.out) for r in reqs)
        else:
            out = generate(cfg, ShardCtx(), params, {"tokens": prompt},
                           run["gen"])
            n_tok = run["batch"] * run["gen"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: s.launches for k, s in spies.items()}
    n_pre = timer.calls.get("prefill", 0)
    n_dec = timer.calls.get("decode", 0)
    rec = dict(out=out, wall_s=wall, tokens=n_tok, prefills=n_pre,
               decode_steps=n_dec,
               prefill_ms=timer.seconds.get("prefill", 0.0) * 1e3 / n_pre,
               decode_ms_per_step=timer.seconds.get("decode", 0.0) * 1e3
               / max(n_dec, 1), tokens_per_s=n_tok / wall)
    if reqs is not None:
        rec["ticks"] = ticks
    print(f"{label} run {name}: " + json.dumps(
        {k: v for k, v in rec.items() if k != "out"})
        + f" launches {launches}")
    if launches != want(n_pre, n_dec):
        fail(f"{label} run {name}: launches {launches} != "
             f"{want(n_pre, n_dec)} implied by {n_pre} prefills and {n_dec} "
             f"decode steps")
    if reqs is None:
        if out.shape != (run["batch"], run["gen"]) or \
                not ((0 <= out) & (out < cfg.vocab)).all():
            fail(f"{label} run {name}: tokens of shape {tuple(out.shape)} "
                 f"or outside the vocabulary")
        if n_dec != run["gen"] - 1:
            fail(f"{label} run {name}: {n_dec} decode steps for "
                 f"{run['gen']} tokens")
    else:
        for r in reqs:
            if not r.done or len(r.out) != r.max_new:
                fail(f"{label} run {name}: request {r.rid} gave "
                     f"{len(r.out)} of {r.max_new} tokens")
    return rec, launches


def check_against_plain(label, spies, plain, stress, ops):
    """Each spied kernel against its plain version on the same device
    tensors, at every shape the path launched and a stress shape; fails
    outside ``close_to_plain``. Returns the largest error per kernel."""
    import torch
    max_err = {}
    for name, spy in spies.items():
        cases = [(f"path{k}", a, kw) for k, (a, kw) in spy.calls.items()]
        cases.append(("stress", *stress[name]()))
        max_err[name] = 0.0
        for case, args, kw in cases:
            got = getattr(ops, name)(*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if name == "flash_decode" and not torch.equal(
                    getattr(ops, name)(*args, **kw), got):
                fail(f"{label} {name} {case}: two launches differ")
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                ok, err = close_to_plain(g, w)
                if not ok:
                    fail(f"{label} {name} {case}: kernel not within "
                         f"tolerance of the plain version (max abs err "
                         f"{err:.3e})")
                max_err[name] = max(max_err[name], err)
        print(f"{label} {name}: {len(cases)} shapes within tolerance of the "
              f"plain version, max abs err {max_err[name]:.3e}"
              + (", bitwise equal across launches"
                 if name == "flash_decode" else ""))
    return max_err


def teacher_forced(cfg, params, prompt, toks):
    """(B, n, V) float32 logits of the prefill of ``prompt`` and of every
    decode step fed ``toks`` (the run's own tokens)."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import make_prefill, make_serve_step, \
        pad_cache_to
    ctx = ShardCtx()
    prefill, step = make_prefill(cfg, ctx), make_serve_step(cfg, ctx)
    b, s = prompt.shape
    logits, cache = prefill(params, {"tokens": prompt})
    cache = pad_cache_to(cfg, cache, b, s + toks.shape[1])
    out = [logits.float()]
    for i in range(toks.shape[1] - 1):
        _, logits, cache = step(params, cache, toks[:, i:i + 1], s + i)
        out.append(logits.float())
    return torch.stack(out, dim=1)


def kernel_and_plain_logits(label, cfg, params, prompt, toks, ops, *,
                            greedy=True):
    """``teacher_forced`` logits of the kernel path and of the same model
    on the card with the entry points swapped for their plain versions.
    Fails on non-finite kernel-path logits, and where ``greedy``, when
    re-running the kernel path does not give the run's own tokens."""
    import torch
    kern = teacher_forced(cfg, params, prompt, toks)
    if not torch.isfinite(kern).all():
        fail(f"{label} run A: non-finite logits on the kernel path")
    if greedy and not torch.equal(kern.argmax(-1), toks):
        fail(f"{label} run A: re-running the kernel path gave other greedy "
             f"tokens")
    with plain_serving_kernels(ops):
        plain = teacher_forced(cfg, params, prompt, toks)
    return kern, plain


def check_teacher_forced(label, cfg, params, prompt, toks, ops):
    """The run's tokens fed back: the kernel path's logits at the prefill
    and every decode step against the plain path's."""
    kern, ref_logits = kernel_and_plain_logits(label, cfg, params, prompt,
                                               toks, ops)
    d_logit = float((kern - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    top1 = float((kern.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    print(f"{label} run A teacher-forced: max |dlogit| {d_logit:.4e} over "
          f"{kern.shape[1]} positions x {kern.shape[0]} rows, bound "
          f"{LOGIT_REL} x max|logit| {scale:.4f} = {LOGIT_REL * scale:.4e}; "
          f"top-1 agreement {top1:.4f}")
    # bound: the tolerance the CPU tests hold the bf16 model to against
    # the reference (tests/test_torch_models.py), 5e-2 of the largest logit
    if not d_logit <= LOGIT_REL * scale:
        fail(f"{label} run A: kernel path logits off the plain versions' by "
             f"{d_logit:.4e} > {LOGIT_REL * scale:.4e}")


def check_teacher_forced_f32(label, cfg, params, prompt, toks, ops):
    """Run A's tokens fed back through four versions of the same model on
    the card: kernel and plain path, each in bf16 and with the weights
    cast to float32. Two gates. In float32 the kernel path is within
    ``F32_LOGIT_REL`` of the plain path's largest logit (the CPU tests'
    float32 tolerance against the reference: the kernels differ from
    their plain versions only in the order of float32 sums). In bf16 the
    kernel path is no further from the float32 logits than the plain path
    is, within ``BF16_ERR_RATIO`` (both round every activation to bf16 at
    the same places; a random 48-layer model amplifies those roundings,
    so their logits differ by several per cent of the largest one and a
    fixed bound on that difference would measure the model, not the
    kernels). The bf16 gate's power is read on every run: the kernel path
    with ``ssd_scan`` swapped for each planted fault must fail it."""
    import copy

    import torch
    kern, plain = kernel_and_plain_logits(label, cfg, params, prompt, toks,
                                          ops)
    cfg32 = cfg.replace(dtype="float32")
    params32 = copy.deepcopy(params).float()
    kern32, plain32 = kernel_and_plain_logits(label, cfg32, params32, prompt,
                                              toks, ops, greedy=False)
    del params32
    scale = float(plain32.abs().max())
    d32 = float((kern32 - plain32).abs().max())
    err_kern = float((kern - plain32).abs().max())
    err_plain = float((plain - plain32).abs().max())
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"{label} run A teacher-forced over {kern.shape[1]} positions x "
          f"{kern.shape[0]} rows: float32 kernel vs plain max |dlogit| "
          f"{d32:.4e}, bound {F32_LOGIT_REL} x max|logit| {scale:.4f} = "
          f"{F32_LOGIT_REL * scale:.4e}; bf16 kernel vs plain max |dlogit| "
          f"{float((kern - plain).abs().max()):.4e}, top-1 agreement "
          f"{top1:.4f}; off the float32 logits: bf16 kernel path "
          f"{err_kern:.4e}, bf16 plain path {err_plain:.4e}, ratio "
          f"{err_kern / err_plain:.4f} (bound {BF16_ERR_RATIO})")
    if not d32 <= F32_LOGIT_REL * scale:
        fail(f"{label} run A: float32 kernel path logits off the plain "
             f"versions' by {d32:.4e} > {F32_LOGIT_REL * scale:.4e}")
    if not err_kern <= BF16_ERR_RATIO * err_plain:
        fail(f"{label} run A: bf16 kernel path {err_kern:.4e} off the "
             f"float32 logits, more than {BF16_ERR_RATIO} x the plain "
             f"path's {err_plain:.4e}")
    for name, fault in (("dropped carry", scan_without_carry),
                        ("rounded apart", scan_rounded_apart)):
        with swapped(ops, ssd_scan=fault):
            err = float((teacher_forced(cfg, params, prompt, toks)
                         - plain32).abs().max())
        print(f"{label} run A bf16 gate, planted fault '{name}' in "
              f"ssd_scan: {err:.4e} off the float32 logits, ratio "
              f"{err / err_plain:.4f} (sound {err_kern / err_plain:.4f}, "
              f"bound {BF16_ERR_RATIO})")
        if name in GATED_FAULTS and err <= BF16_ERR_RATIO * err_plain:
            fail(f"{label} run A: the bf16 gate passes the planted fault "
                 f"'{name}' ({err:.4e} <= {BF16_ERR_RATIO} x {err_plain:.4e})")


def check_batched_equals_alone(label, cfg, params, reqs, dev):
    """Run C determinism: each request alone through ``generate``."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import generate
    for r in reqs:
        alone = generate(cfg, ShardCtx(), params,
                         {"tokens": torch.as_tensor(r.prompt, device=dev)
                          .long()[None]}, len(r.out),
                         max_seq=RUN_C["max_seq"])
        if alone[0].tolist() != r.out:
            fail(f"{label} run C: request {r.rid} (prompt {len(r.prompt)}) "
                 f"decoded differently batched than alone")
    print(f"{label} run C: {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}, max_new "
          f"{[r.max_new for r in reqs]}) equal to generate alone, token for "
          f"token")


def profile_step(step, breakdown):
    """Five unsynchronised calls of ``step()`` back to back (host ms per
    step), then ``torch.profiler`` over three: device busy ms, kernels
    and idle share per step, and the ten kernels with the most device
    time. Adds them to ``breakdown``."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 5
    breakdown["step_ms_unsynced"] = step_ms
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        # only the device's own events: a CPU op carries its kernels'
        # device time too (the rule of the profiler's own table footer)
        evts = [e for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and not getattr(e, "is_user_annotation", False)]

        def dev_time(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
        dev_us = sum(dev_time(e) for e in evts)
        n_kern = sum(e.count for e in evts)
        breakdown["top_device_time_per_step"] = [
            dict(name=e.key[:80], calls=e.count / 3,
                 ms=dev_time(e) / 1e3 / 3)
            for e in sorted(evts, key=dev_time, reverse=True)[:10]]
        breakdown["device_busy_ms_per_step"] = dev_us / 1e3 / 3 \
            if dev_us else "not measured"
        breakdown["device_kernels_per_step"] = n_kern / 3 if n_kern \
            else "not measured"
        if dev_us:
            breakdown["device_idle_share"] = 1.0 - dev_us / 1e3 / 3 / step_ms
    except Exception as e:          # the profiler is untried on this machine
        breakdown["device_busy_ms_per_step"] = f"not measured ({e!r})"
    return breakdown


def decode_breakdown(label, cfg, params, prompt, gen_len, extra=None):
    """``profile_step`` of one decode step after the prefill of
    ``prompt`` (cache padded for ``gen_len`` tokens), with ``extra``
    (e.g. a bound) beside it, printed."""
    from repro_torch.models import ShardCtx
    from repro_torch.runtime import (make_prefill, make_serve_step,
                                     pad_cache_to)
    ctx = ShardCtx()
    prefill, step = make_prefill(cfg, ctx), make_serve_step(cfg, ctx)
    logits, cache = prefill(params, {"tokens": prompt})
    b, s = prompt.shape
    cache = pad_cache_to(cfg, cache, b, s + gen_len)
    tok = logits.argmax(-1)[:, None]
    out = profile_step(lambda: step(params, cache, tok, s), {})
    out.update(extra or {})
    print(f"{label} decode step breakdown (host ms) " + json.dumps(out))
    return out


def spy_keys():
    """How each serving entry point's calls are told apart by the spies:
    (key of the positional arguments, keyword arguments in the key)."""
    def key_norm(args):
        return (tuple(args[0].shape), args[0].dtype, args[1].dtype)

    def key_scan(args):
        return (shapes(args[:5]), args[0].dtype, args[5:])
    return {"rmsnorm": (key_norm, ("zero_centered",)),
            "flash_attention": (shapes, ("window", "softcap")),
            "flash_decode": (shapes, ("ring", "softcap")),
            "ssd_scan": (key_scan, ())}


def stress_cases(gen, dev):
    """A ragged stress input per kernel, off every path shape."""
    import torch

    def stress_norm():
        x = torch.randn((37, 1001), generator=gen, device=dev).bfloat16()
        w = torch.randn((1001,), generator=gen, device=dev).bfloat16() * 0.1
        return [x, w], {"zero_centered": True}

    def stress_attn():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((2, 1000, 8, 256), (2, 1000, 4, 256),
                                 (2, 1000, 4, 256)))
        return [q, k, v], {"window": 300, "softcap": 50.0,
                           "scale": 256 ** -0.5}

    def stress_decode():
        q = torch.randn((3, 8, 256), generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn((3, 1001, 4, 256), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        pos = torch.tensor([5, 1000, 3000], dtype=torch.int32, device=dev)
        return [q, kc, vc, pos], {"softcap": 50.0, "ring": True}

    def stress_scan():
        # P, N and chunk off the kernel's tile grid, three groups, a
        # ragged last chunk; A and dt as Mamba-2 initialises them
        b, s, h, p, g, n, chunk = 3, 300, 6, 40, 3, 100, 96
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        u = torch.rand((b, s, h), generator=gen, device=dev)
        dt = torch.exp(-6.9078 + 4.6052 * u)
        A = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device=dev))
        B, C = (torch.randn((b, s, g, n), generator=gen, device=dev)
                for _ in range(2))
        return [x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), chunk], {}

    return {"rmsnorm": stress_norm, "flash_attention": stress_attn,
            "flash_decode": stress_decode, "ssd_scan": stress_scan}


def plain_versions():
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch
    return {"rmsnorm": rmsnorm_torch, "flash_attention": flash_attention_torch,
            "flash_decode": flash_decode_torch, "ssd_scan": ssd_scan_torch}


def norm_row(x, w, nkw):
    """``rmsnorm`` at one shape: the kernel's, the plain version's and
    ``F.rms_norm``'s device ms from a CUDA graph of 50 calls (a short
    kernel's back-to-back time is the host's dispatch), their
    back-to-back ms beside them (``*_eager_ms``), the bound and what
    bounds it. Successive calls take turns over copies of ``x`` that
    together hold three times the L2 cache, so each call reads its input
    from device memory, as the bound counts it."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    n_bytes = x.numel() * 2 * x.element_size() + w.numel() * w.element_size()
    b_ms, b_by = bound(n_bytes, 4 * x.numel(), FP32_OPS_PER_S)
    copies = [x] + [x.clone() for _ in range(-(-3 * L2_BYTES // n_bytes))]
    turn = itertools.count()

    def x_():
        return copies[next(turn) % len(copies)]

    def kernel():
        return rmsnorm_cuda(x_(), w, **nkw)

    def plain():
        return rmsnorm_torch(x_(), w, **nkw)

    def library():
        return F.rms_norm(x_(), (x.shape[-1],), w, nkw.get("eps", 1e-6))
    return dict(
        shape=str(tuple(x.shape)), ms=graph_ms(kernel, 50),
        plain_ms=graph_ms(plain, 50), bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(library, 50), eager_ms=cuda_ms(kernel, 50),
        library_eager_ms=cuda_ms(library, 50), bytes=n_bytes)


def norm_rows_by_width(label, spy):
    """``norm_row`` at every prefill width the path launched (the call
    with the most rows per width), printed; returns the rows by width."""
    widest = {}
    for (args, kw) in spy.calls.values():
        x = args[0]
        if x.dim() >= 3 and x.shape[1] > 1 and (
                x.shape[-1] not in widest
                or x.numel() > widest[x.shape[-1]][0][0].numel()):
            widest[x.shape[-1]] = (args, kw)
    rows = {}
    for d in sorted(widest):
        (x, w), kw = widest[d]
        rows[d] = norm_row(x, w, kw)
        print(f"{label} rmsnorm at prefill width {d} "
              f"(vs F.rms_norm, device ms from a CUDA graph) "
              + json.dumps(rows[d]))
    return rows


def attention_row(q, k, v, akw, library=None):
    """``flash_attention`` at one shape: the kernel's ms, the plain
    version's, the library call's where given, TFLOP/s against the
    bound's operation count, the bound and what bounds it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_torch)
    n_bytes, flops = attn_cost(q, k, v, causal=akw.get("causal", True),
                               window=akw.get("window"))
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **akw), 20)
    return dict(
        shape=str(tuple(q.shape)) + f" window={akw.get('window')} "
              f"softcap={akw.get('softcap')}",
        ms=ms, tflops=flops / ms / 1e9,
        plain_ms=cuda_ms(lambda: flash_attention_torch(q, k, v, **akw), 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_ms(library, 20),
        bytes=n_bytes, flops=flops, args=((q, k, v), akw))


def decode_row(q, kc, vc, pos, dkw):
    """``flash_decode`` at one shape: the kernel's, the plain version's
    and (without a softcap, where it computes the same function)
    ``scaled_dot_product_attention``'s device ms from a CUDA graph of
    calls that take turns over copies of the cache holding three times
    the L2, so each reads the cache from device memory as the path's
    layers do; the kernel's and the library's back-to-back ms on one
    cache beside them (``*_eager_ms``, the path's launch cost and an L2
    that is warm); the bound and what bounds it."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_torch,
                                                  valid_slots)
    ring = dkw.get("ring", False)
    n_bytes, flops = decode_cost(q, kc, vc, pos, ring=ring)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    cache = kc.numel() * kc.element_size() + vc.numel() * vc.element_size()
    copies = [(kc, vc)] + [(kc.clone(), vc.clone())
                           for _ in range(-(-3 * L2_BYTES // cache))]
    turn = itertools.count()
    mask = valid_slots(pos, kc.shape[1], ring)[:, None, None, :]

    def kernel():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_cuda(q, k, v, pos, **dkw)

    def plain():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_torch(q, k, v, pos, **dkw)

    def library(k=kc, v=vc):
        return sdpa(q[:, None], k, v, mask, False, dkw.get("scale"))[:, 0]

    def library_turns():
        return library(*copies[next(turn) % len(copies)])
    plain_lib = dkw.get("softcap") is None

    def ten_calls():
        for _ in range(10):
            kernel()
    # the device ms of each of the kernel's launches (split, combine)
    by_kernel = {}
    for e in profile_step(ten_calls, {}).get("top_device_time_per_step", []):
        name = re.search(r"decode_\w+_kernel", e["name"])
        if name:
            by_kernel[name.group(0)] = e["ms"] / 10
    return dict(
        shape=f"q {tuple(q.shape)} cache {tuple(kc.shape)} ring={ring} "
              f"softcap={dkw.get('softcap')} pos={pos.tolist()}",
        ms=graph_ms(kernel, 50), plain_ms=graph_ms(plain, 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(library_turns, 50) if plain_lib else None,
        eager_ms=cuda_ms(lambda: flash_decode_cuda(q, kc, vc, pos, **dkw),
                         50),
        library_eager_ms=cuda_ms(library, 50) if plain_lib else None,
        device_ms_by_kernel=by_kernel or "not measured",
        copies=len(copies), bytes=n_bytes, flops=flops,
        args=((q, kc, vc, pos), dkw))


def serving_kernel_rows(label, spies):
    """Per serving kernel at its largest path shape: the kernel's, the
    plain version's and (where one exists) the library call's ms from
    CUDA events, the bound and what bounds it; ``rmsnorm`` at every
    prefill width, printed."""
    rows = {"rmsnorm": max(norm_rows_by_width(label, spies["rmsnorm"])
                           .values(), key=lambda row: row["bytes"])}

    def attn_key(kv):
        (q, k, v), kw = kv[1]
        return attn_cost(q, k, v, causal=kw.get("causal", True),
                         window=kw.get("window"))[1]
    _, ((q, k, v), akw) = max(spies["flash_attention"].calls.items(),
                              key=attn_key)
    # no library call softcaps; without a softcap and a window, causal
    # scaled_dot_product_attention computes the same function
    library = None
    if akw.get("softcap") is None and akw.get("window") is None:
        def library():
            return sdpa(q, k, v, None, akw.get("causal", True),
                        akw.get("scale"))
    rows["flash_attention"] = attention_row(q, k, v, akw, library)

    def dec_key(kv):
        (q, kc, vc, pos), kw = kv[1]
        return decode_cost(q, kc, vc, pos, ring=kw.get("ring", False))[0]
    _, ((dq, dkc, dvc, dpos), dkw) = max(spies["flash_decode"].calls.items(),
                                         key=dec_key)
    rows["flash_decode"] = decode_row(dq, dkc, dvc, dpos, dkw)
    return rows


def print_rows(label, rows):
    for name, row in rows.items():
        print(f"{label} {name} " + json.dumps(
            {k: v for k, v in row.items() if k != "args"}))


def serve_phase(dev):
    """Serve gemma2-2b at full width and depth in bf16 (runs A, B, C),
    check it and time it; returns the three kernels' JSON entries."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     visible)
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  valid_slots)
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.models.layers import embed_tokens, softcap
    from repro_torch.models.model import _head
    from repro_torch.runtime import (generate, make_prefill, make_serve_step,
                                     pad_cache_to)

    # the plain versions' einsums and the model's matmuls in full float32
    # where they take float32 (the plain attention's scores), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS[SERVE_ARCH]
    n_layers = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    redraw(params, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve: {cfg.name} {n_layers} layers d={cfg.d_model} "
          f"params={n_params} ({n_params * 2 / 1e9:.2f} GB bf16) "
          f"init_s={time.perf_counter() - t0:.1f}")
    ctx = ShardCtx()

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    # warm-up (cuBLAS handles, kernel libraries loaded): not counted
    generate(cfg, ctx, params, {"tokens": tokens(1, 16)}, 2)
    torch.cuda.synchronize()

    prompt_a = tokens(RUN_A["batch"], RUN_A["prompt"])
    prompt_b = tokens(RUN_B["batch"], RUN_B["prompt"])
    reqs = ragged_requests(cfg.vocab)

    def want(n_pre, n_dec):
        return {"rmsnorm": (n_pre + n_dec) * (4 * n_layers + 1),
                "flash_attention": n_pre * n_layers,
                "flash_decode": n_dec * n_layers}

    runs, launches = {}, {}
    keys = spy_keys()
    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SERVE_KERNELS}
        for name, run, prompt, rq in (("A", RUN_A, prompt_a, None),
                                      ("B", RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[name] = drive(
                "serve", name, run, cfg, params, spies, want, prompt=prompt,
                reqs=rq)

    stress = stress_cases(gen, dev)
    max_err = check_against_plain("serve", spies, plain_versions(), stress,
                                  ops)
    check_teacher_forced("serve", cfg, params, prompt_a, runs["A"]["out"],
                         ops)
    check_batched_equals_alone("serve", cfg, params, reqs, dev)

    # -- per kernel at its largest path shape --------------------------------
    rows = serving_kernel_rows("serve", spies)
    print_rows("serve", rows)

    # side rows: no softcap, against scaled_dot_product_attention (which
    # cannot softcap), the window passed as an explicit mask
    (q, k, v), akw = rows["flash_attention"]["args"]
    side = []
    for label, win in (("global", None), ("local", cfg.window)):
        s = q.shape[1]
        scale = akw.get("scale")
        mask = None if win is None else \
            visible(s, causal=True, window=win, device=dev)
        got = flash_attention_cuda(q, k, v, window=win, scale=scale)
        lib = sdpa(q, k, v, mask, True, scale)
        row = attention_row(q, k, v, dict(window=win, scale=scale),
                            lambda: sdpa(q, k, v, mask, True, scale))
        side.append(dict(
            kernel="flash_attention", softcap=None, layer=label,
            max_abs_diff=float((got.float() - lib.float()).abs().max()),
            **{k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    (dq, dkc, dvc, dpos), dkw = rows["flash_decode"]["args"]
    dmask = valid_slots(dpos, dkc.shape[1], dkw["ring"])[:, None, None, :]
    nkw = dict(ring=dkw["ring"], scale=dkw.get("scale"))
    got = flash_decode_cuda(dq, dkc, dvc, dpos, **nkw)
    lib = sdpa(dq[:, None], dkc, dvc, dmask, False, nkw["scale"])[:, 0]
    row = decode_row(dq, dkc, dvc, dpos, nkw)
    side.append(dict(
        kernel="flash_decode", softcap=None,
        max_abs_diff=float((got.float() - lib.float()).abs().max()),
        **{k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    for row in side:
        print("side row (no softcap) vs scaled_dot_product_attention "
              + json.dumps(row))

    # -- where one decode step's time goes (run A's shape) -------------------
    prefill = make_prefill(cfg, ctx)
    logits, cache = prefill(params, {"tokens": prompt_a})
    b, s = prompt_a.shape
    cache = pad_cache_to(cfg, cache, b, s + RUN_A["gen"])
    tok = logits.argmax(-1)[:, None]
    parts = {"embed": [], "layers": [], "head": [], "argmax": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = embed_tokens(tok, params.embed, cfg.embed_scale_by_dim)
        torch.cuda.synchronize()
        parts["embed"].append(time.perf_counter() - t)
        t = time.perf_counter()
        for i, layer in enumerate(params.layers):
            x, _, _ = layer(x, cfg=cfg, mode="decode", positions=s,
                            cache=cache[i])
        torch.cuda.synchronize()
        parts["layers"].append(time.perf_counter() - t)
        t = time.perf_counter()
        lg = softcap(_head(params, x, cfg)[:, 0], cfg.logit_softcap)
        torch.cuda.synchronize()
        parts["head"].append(time.perf_counter() - t)
        t = time.perf_counter()
        lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        parts["argmax"].append(time.perf_counter() - t)
    step = make_serve_step(cfg, ctx)
    breakdown = {k: float(np.median(v)) * 1e3 for k, v in parts.items()}
    profile_step(lambda: step(params, cache, tok, s), breakdown)
    print("decode step breakdown (run A shape, host ms, synchronised per "
          "part) " + json.dumps(breakdown))

    return [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces={"rmsnorm": "src/repro/kernels/rmsnorm.py:29",
                  "flash_attention": "src/repro/kernels/flash_attention.py:86",
                  "flash_decode": "src/repro/kernels/flash_decode.py:70"}[name],
        launches=sum(launches[r][name] for r in launches),
        launches_by_path={f"serve_{r}": launches[r][name] for r in launches},
        max_abs_err=max_err[name], ms=rows[name]["ms"],
        plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
        bound_by=rows[name]["bound_by"], library_ms=rows[name]["library_ms"],
        shape=rows[name]["shape"]) for name in SERVE_KERNELS]


def ssm_phase(dev):
    """Serve mamba2-780m (runs A, B, C) and zamba2-7b (run D) at full
    width and depth in bf16, check them and time them. Returns the
    ``ssd_scan`` JSON entry and, per serving kernel, its counts by run
    and its largest error against the plain version here."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ShardCtx()
    runs, launches, breakdowns = {}, {}, {}
    keys = spy_keys()

    def load(arch):
        cfg = ARCHS[arch]
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"ssm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
              f"heads={cfg.ssm_heads}x{cfg.ssm_headdim} "
              f"state={cfg.ssm_state} chunk={cfg.ssm_chunk} "
              f"params={n_params} ({n_params * 2 / 1e9:.2f} GB bf16) "
              f"init_s={time.perf_counter() - t0:.1f}")
        generate(cfg, ctx, params, {"tokens": torch.randint(
            0, cfg.vocab, (1, 16), generator=gen, device=dev)}, 2)  # warm-up
        torch.cuda.synchronize()
        return cfg, gen, params

    def want_of(cfg):
        n_rep = cfg.repeat_structure()[1] if cfg.shared_attn_every else 0
        n = cfg.n_layers

        def want(n_pre, n_dec):
            return {"rmsnorm": (n_pre + n_dec) * (2 * n + 2 * n_rep + 1),
                    "flash_attention": n_pre * n_rep,
                    "flash_decode": n_dec * n_rep,
                    "ssd_scan": n_pre * n}
        return want

    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SSM_KERNELS}

        # -- mamba2-780m: runs A, B, C ---------------------------------------
        cfg, gen, params = load("mamba2-780m")
        prompt_a = torch.randint(0, cfg.vocab, (SSM_RUN_A["batch"],
                                                SSM_RUN_A["prompt"]),
                                 generator=gen, device=dev)
        prompt_b = torch.randint(0, cfg.vocab, (SSM_RUN_B["batch"],
                                                SSM_RUN_B["prompt"]),
                                 generator=gen, device=dev)
        reqs = ragged_requests(cfg.vocab)
        for name, run, prompt, rq in (("A", SSM_RUN_A, prompt_a, None),
                                      ("B", SSM_RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[name] = drive(
                "mamba2", name, run, cfg, params, spies, want_of(cfg),
                prompt=prompt, reqs=rq)
        check_teacher_forced_f32("mamba2", cfg, params, prompt_a,
                                 runs["A"]["out"], ops)
        check_batched_equals_alone("mamba2", cfg, params, reqs, dev)
        breakdowns["mamba2_A"] = decode_breakdown(
            "mamba2 run A shape", cfg, params, prompt_a, SSM_RUN_A["gen"])
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # -- zamba2-7b: run D ------------------------------------------------
        cfg, gen, params = load("zamba2-7b")
        prompt_d = torch.randint(0, cfg.vocab, (SSM_RUN_D["batch"],
                                                SSM_RUN_D["prompt"]),
                                 generator=gen, device=dev)
        runs["D"], launches["D"] = drive(
            "zamba2", "D", SSM_RUN_D, cfg, params, spies, want_of(cfg),
            prompt=prompt_d)
        breakdowns["zamba2_D"] = decode_breakdown(
            "zamba2 run D shape", cfg, params, prompt_d, SSM_RUN_D["gen"])
        print(f"zamba2 peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params
        gc.collect()
        torch.cuda.empty_cache()

    max_err = check_against_plain("ssm", spies, plain_versions(),
                                  stress_cases(gen, dev), ops)
    rows = serving_kernel_rows("ssm", {k: spies[k] for k in SERVE_KERNELS})
    print_rows("ssm", rows)
    # zamba2's shared block has no softcap and no window: causal
    # scaled_dot_product_attention computes the same function
    (q, k, v), akw = rows["flash_attention"]["args"]
    if rows["flash_attention"]["library_ms"] is not None:
        got = flash_attention_cuda(q, k, v, **akw)
        lib = sdpa(q, k, v, None, akw.get("causal", True), akw.get("scale"))
        print("ssm side row (no softcap, no window) vs "
              "scaled_dot_product_attention " + json.dumps(dict(
                  kernel="flash_attention", shape=str(tuple(q.shape)),
                  ms=rows["flash_attention"]["ms"],
                  library_ms=rows["flash_attention"]["library_ms"],
                  max_abs_diff=float((got.float() - lib.float()).abs()
                                     .max()))))

    # ssd_scan at every path shape of the generate runs (A, B, D) and of
    # run C's prompts: kernel and plain ms, bound
    scan_rows = []
    by_flops = sorted(spies["ssd_scan"].calls.values(),
                      key=lambda call: -ssd_cost(*call[0])[1])
    for args, _ in by_flops:
        x, dt, A, B, C, chunk = args
        n_bytes, flops = ssd_cost(x, dt, A, B, C, chunk)
        b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
        got, want = ssd_scan_cuda(*args), ssd_scan_torch(*args)
        scan_rows.append(dict(
            run=(SCAN_RUNS.get(tuple(x.shape), "other")
                 if x.dtype == torch.bfloat16 else "float32 check"),
            shape=f"x {tuple(x.shape)} B {tuple(B.shape)} chunk {chunk}",
            gate_ratio_y=gate_ratio(got[0], want[0]),
            gate_ratio_state=gate_ratio(got[1], want[1]),
            ms=cuda_ms(lambda: ssd_scan_cuda(x, dt, A, B, C, chunk), 10),
            plain_ms=cuda_ms(lambda: ssd_scan_torch(x, dt, A, B, C, chunk),
                             3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=n_bytes,
            flops=flops))
        print("ssd_scan " + json.dumps(scan_rows[-1]))
    top = scan_rows[0]
    # where the largest call's time goes: device ms per launch of each
    # pass (the profiler's total over the launches it saw)
    x, dt, A, B, C, chunk = by_flops[0][0]
    passes = profile_step(lambda: ssd_scan_cuda(x, dt, A, B, C, chunk),
                          {}).get("top_device_time_per_step", [])
    top["passes_ms"] = {e["name"]: e["ms"] / e["calls"] for e in passes}
    print(f"ssd_scan passes at {top['shape']} "
          + json.dumps(top["passes_ms"]))
    label = {"A": "mamba2_A", "B": "mamba2_B", "C": "mamba2_C",
             "D": "zamba2_D"}
    by_run = {k: {label[r]: launches[r][k] for r in launches}
              for k in SSM_KERNELS}
    ssd_entry = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:74",
        launches=sum(by_run["ssd_scan"].values()),
        launches_by_path=by_run["ssd_scan"],
        max_abs_err=max_err["ssd_scan"], ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shape=top["shape"])
    return ssd_entry, by_run, max_err


# -- 8. dense sim_step relaxation; 9. the device-resident GA; 10. the
#       verifier ----------------------------------------------------------

DEVICE_GA_APPS = ("64core", "256core")


def dense_bounds(b, s, depth):
    """(call bound ms, streaming bound ms, by): inputs read once and the
    output written once over the memory rate, against two adds and a max
    per (b, s, j) over the float32 rate; the streaming bound re-reads the
    lags, the ends, the durations and the floors every sweep."""
    n_bytes = 2 * b * s * s * 4 + 2 * b * s * 4 + b * s * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * b * s * s / FP32_OPS_PER_S * 1e3
    per_sweep = (2 * b * s * s * 4 + 4 * b * s * 4) / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), depth * per_sweep,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


def dense_args(batch, dur, dev):
    """``dense_lags`` of a lowered batch, with its host ms, and the dense
    kernel's inputs on the card (float32, contiguous)."""
    import numpy as np
    import torch

    from repro_torch.core.lowering import dense_lags
    t0 = time.perf_counter()
    lat, volbw = dense_lags(batch)
    host_ms = (time.perf_counter() - t0) * 1e3
    args = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in (lat, volbw, dur, batch.release)]
    return args, host_ms


def dense_phase(dev, runs):
    """The reference's dense path on the four offline shapes:
    ``lint_batch`` -> ``dense_lags`` -> ``ops.sim_relax(n_steps=depth)``,
    each shape's result held to its plain version (``torch.equal``), to
    the float64 ``relax_batch_np`` and to the sparse ``simulate_batch``
    of phase 2 (rtol 1e-5); ``ops.sim_step`` against its plain version at
    ragged stress shapes with -inf and NaN."""
    import numpy as np
    import torch

    from repro_torch.analysis import lint_batch
    from repro_torch.core import batch_scenarios, lower_scenario
    from repro_torch.core.sim_engine import _jitter_durations, relax_batch_np
    from repro_torch.kernels import ops
    from repro_torch.kernels.sim_step import (_dense_relax_cuda,
                                              compact_lags_cuda,
                                              compact_lags_torch,
                                              fixpoint_sweeps_torch, pop_plan,
                                              sim_relax_cuda,
                                              sim_relax_pop_cuda,
                                              sim_relax_torch, sim_step_cuda,
                                              sim_step_torch)

    shapes = []
    for r in runs:
        batch = batch_scenarios([lower_scenario(g, r["machine"], sc)
                                 for g, sc in zip(r["graphs"],
                                                  r["schedules"])])
        lint_batch(batch)
        dur = _jitter_durations(batch, r["jitter"], r["seeds"])
        shapes.append((r, batch, dur))
    ops.sim_relax.launches = ops.sim_step.launches = 0
    ops.sim_relax.variants = {"compact": 0, "dense": 0}
    ops.sim_relax_pop.launches = 0
    outs = []
    for r, batch, dur in shapes:
        args, host_ms = dense_args(batch, dur, dev)
        outs.append((args, host_ms,
                     ops.sim_relax(*args, n_steps=batch.depth)))
    torch.cuda.synchronize()
    launches = ops.sim_relax.launches + ops.sim_step.launches
    variants = dict(ops.sim_relax.variants)
    print(f"dense path launches: sim_relax {ops.sim_relax.launches} "
          f"(variants {variants}), sim_step {ops.sim_step.launches}, "
          f"ops.sim_relax_pop {ops.sim_relax_pop.launches}")
    if launches == 0:
        fail("kernel sim_step was never launched on the dense path")
    if variants != {"compact": len(shapes), "dense": 0}:
        fail(f"sim_relax: the compact variant did not give every shape "
             f"({variants})")
    if ops.sim_relax_pop.launches:
        fail("sim_relax moved ops.sim_relax_pop's count")

    rows, err = [], 0.0
    for (r, batch, dur), (args, host_ms, got) in zip(shapes, outs):
        name, depth = r["name"], batch.depth
        want = sim_relax_torch(*args, n_steps=depth)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sim_step {name}: kernel != plain version, max abs err "
                 f"{(got - want).abs().max().item():.3e}")
        end = got.cpu().numpy().astype(np.float64)
        for ref_name, ref in (("relax_batch_np", relax_batch_np(batch, dur)),
                              ("sparse simulate_batch",
                               r["res"].subtask_end)):
            if not np.allclose(end, ref, rtol=RTOL_F32, atol=0.0):
                rel = np.abs(end - ref) / np.maximum(np.abs(ref), 1e-30)
                fail(f"sim_step {name}: dense vs {ref_name} rel err "
                     f"{rel.max():.3e} > {RTOL_F32}")
        b, s = batch.n_scenarios, batch.max_subtasks
        # the compaction and the stopped relaxation, each against its
        # plain version: the same form, the same sweeps per row
        _, info = sim_relax_cuda(*args, n_steps=depth, with_info=True)
        comp = compact_lags_cuda(*args)
        want_comp = compact_lags_torch(*args)
        if not all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(comp, want_comp)):
            fail(f"sim_step {name}: compact_lags kernel != plain version")
        _, want_sweeps = fixpoint_sweeps_torch(*want_comp[:3], *args[2:],
                                               n_steps=depth)
        if not (bool(info.compact.all())
                and torch.equal(info.sweeps, want_sweeps.cpu())):
            fail(f"sim_step {name}: compact variant's sweeps (max "
                 f"{int(info.sweeps.max())}) != the plain stop's (max "
                 f"{int(want_sweeps.max())}) or a scenario went dense")
        del want_comp
        bound, stream, by, n_bytes = dense_bounds(b, s, depth)
        ms = cuda_ms(lambda: sim_relax_cuda(*args, n_steps=depth), 5)
        compact_ms = cuda_ms(lambda: compact_lags_cuda(*args), 5)
        relax_ms = cuda_ms(lambda: sim_relax_pop_cuda(
            *comp[:3], *args[2:], n_steps=depth, with_sweeps=True,
            with_overflow=True), 10)
        dense_out = torch.empty((b, s), device=dev)
        dense_ms = cuda_ms(lambda: _dense_relax_cuda(
            *args, depth, None, dense_out), 2)
        if not torch.equal(dense_out, want):
            fail(f"sim_step {name}: dense variant != plain version")
        end0 = torch.zeros((b, s), device=dev)
        sweep_ms = cuda_ms(lambda: sim_step_cuda(end0, *args), 20)
        plain_ms = cuda_ms(lambda: sim_relax_torch(*args, n_steps=depth), 2)
        plan = pop_plan(*comp.pred.shape)
        rows.append(dict(name=name, B=b, S=s, depth=depth, ms=ms,
                         variant="compact", P1=info.p1,
                         sweeps_max=int(info.sweeps.max()),
                         sweeps_median=float(info.sweeps.float().median()),
                         relax_plan=f"k {plan.k} {plan.variant}",
                         compact_ms=compact_ms, relax_ms=relax_ms,
                         dense_variant_ms=dense_ms,
                         sweep_ms=sweep_ms, plain_ms=plain_ms,
                         bound_ms=bound, streaming_bound_ms=stream,
                         bound_by=by, bytes=n_bytes,
                         dense_lags_host_ms=host_ms,
                         max_abs_err=(got - want).abs().max().item()))
        err = max(err, rows[-1]["max_abs_err"])
        print("sim_step " + json.dumps(rows[-1]))
        del args, got, want, comp, dense_out
        torch.cuda.empty_cache()

    # ops.sim_step against its plain version: ragged S, -inf and NaN
    rng = np.random.default_rng(1)
    for b, s in ((3, 37), (4, 1000)):
        x = [rng.uniform(0.0, 50.0, (b, s)),
             np.where(rng.random((b, s, s)) < 0.05,
                      rng.uniform(0.0, 1e-4, (b, s, s)), -np.inf),
             None, rng.uniform(0.1, 5.0, (b, s)),
             rng.uniform(0.0, 20.0, (b, s))]
        x[2] = np.where(np.isfinite(x[1]), rng.uniform(0.0, 2.0, (b, s, s)),
                        -np.inf)
        x = [a.astype(np.float32) for a in x]
        args = [torch.from_numpy(a).to(dev) for a in x]
        got, want = ops.sim_step(*args), sim_step_torch(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sim_step stress ({b}, {s}): kernel != plain version")
        x[1][rng.random((b, s, s)) < 1e-3] = np.nan
        x[0][0, 5] = np.inf             # inf + -inf: NaN where no edge
        x[3][1, :3] = np.nan
        args = [torch.from_numpy(a).to(dev) for a in x]
        got, want = ops.sim_step(*args), sim_step_torch(*args)
        torch.cuda.synchronize()
        if not torch.isnan(want).any() or not same_scores(got, want):
            fail(f"sim_step nan ({b}, {s}): kernel != plain version")
    print("sim_step stress (3, 37), (4, 1000) with -inf and NaN: equal")

    # ops.sim_relax: a clean scenario (compact), NaN lags and an +inf
    # duration (dense from the start), ends that overflow (compact,
    # flagged, redone dense); 16-byte and 4-byte dense rows
    for b, s in ((4, 256), (4, 257)):
        lat = np.where(rng.random((b, s, s)) < 0.05,
                       rng.uniform(0.0, 1e-4, (b, s, s)), -np.inf)
        volbw = np.where(lat > -np.inf, rng.uniform(0.0, 2.0, (b, s, s)),
                         -np.inf)
        dur = rng.uniform(0.1, 5.0, (b, s))
        rel = rng.uniform(0.0, 20.0, (b, s))
        lat[1][tuple(np.argwhere(lat[1] > -np.inf)[0])] = np.nan
        dur[2, 3] = np.inf
        dur[3] = 2e37
        args = [torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (lat, volbw, dur, rel)]
        before = dict(ops.sim_relax.variants)
        got = ops.sim_relax(*args, n_steps=60)
        want = sim_relax_torch(*args, n_steps=60)
        _, info = sim_relax_cuda(*args, n_steps=60, with_info=True)
        torch.cuda.synchronize()
        if ops.sim_relax.variants != {k: v + 1 for k, v in before.items()}:
            fail(f"sim_relax stress ({b}, {s}): variant counts "
                 f"{ops.sim_relax.variants} from {before}")
        if (info.compact.tolist() != [True, False, False, False]
                or info.redone.tolist() != [False, False, False, True]):
            fail(f"sim_relax stress ({b}, {s}): variants {info}")
        if not torch.isnan(want[3]).any() or not same_scores(got, want):
            fail(f"sim_relax stress ({b}, {s}): kernel != plain version")
    print("sim_relax stress (4, 256), (4, 257) with NaN, +inf and overflow: "
          "equal; compact and dense variants both ran")
    main_row = max(rows, key=lambda x: x["bytes"])
    return dict(
        name="sim_step", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_step.cu",
        replaces="src/repro/kernels/sim_step.py:107", launches=launches,
        launches_by_path={"dense": launches}, max_abs_err=err,
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"],
        variants=variants, compact_ms=main_row["compact_ms"],
        relax_ms=main_row["relax_ms"], sweeps_max=main_row["sweeps_max"],
        sweep_ms=main_row["sweep_ms"],
        streaming_bound_ms=main_row["streaming_bound_ms"])


def device_ga_apps():
    from repro_torch.core import (SynthParams, cluster_of_multicores,
                                  generate_app, hp_bl260c,
                                  paper_suite_64core)
    big64 = max(paper_suite_64core(n_apps=10, seed=100),
                key=lambda g: g.n_subtasks)
    return [("64core", hp_bl260c(), big64),
            ("256core", cluster_of_multicores(32),
             generate_app(SynthParams(n_tasks=(240, 280)), seed=300))]


def replay_device_ga(graph, machine, par, dev, seed=0):
    """``ga_search_device``'s loop run by hand from the search's public
    pieces (``device_inputs``, ``generation_step``,
    ``hill_climb_device``), so that the final population and the refine
    rounds actually run can be read. Returns ``(inp, vec, val, pop, fit,
    rounds)``; the phase holds ``(vec, val)`` to ``ga_search``'s."""
    import numpy as np
    import torch

    from repro_torch.search import device, hill_climb_device

    n_tasks, n_cores = len(graph.tasks), machine.n_cores
    inp = device.device_inputs(graph, machine, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pop = torch.randint(0, max(n_cores, 1), (par.pop_size, n_tasks),
                        generator=gen, device=dev, dtype=torch.int32)
    fit = device.population_fitness_device(inp, pop, method="kernel")
    step = device.generation_step(par, n_tasks=n_tasks, n_cores=n_cores,
                                  method="kernel")
    for _ in range(par.generations):
        pop, fit = step(inp, gen, pop, fit)
    best = int(torch.argmin(fit))
    rounds = [0]

    def counted(inp_, genes):
        rounds[0] += 1
        return device.population_fitness_device(inp_, genes,
                                                method="kernel")

    vec, val = hill_climb_device(
        counted, inp, pop[best].cpu().numpy().astype(np.int32),
        float(fit[best]), generator=gen, rounds=par.refine_rounds,
        moves=par.refine_moves, n_cores=n_cores)
    return inp, vec, val, pop, fit, rounds[0]


def device_ga_phase(dev):
    """``ga_search`` with ``GAParams(device=True)`` at the defaults on
    the card: determinism, kernel fitness == scan fitness on the final
    population, the winner's fitness against the float64 append-only
    decode, ``ga_schedule(device=True) <= engine``, and the
    ``sim_relax_pop`` launch count per search."""
    import numpy as np
    import torch

    from repro_torch.core import (get_scheduler, lower_population,
                                  simulate_batch, validate)
    from repro_torch.kernels import ops
    from repro_torch.kernels.sim_step import (sim_relax_pop_cuda,
                                              sim_relax_pop_torch)
    from repro_torch.search import GAParams, decode, ga_schedule, ga_search
    from repro_torch.search import device

    par = GAParams(device=True)
    rows, pop_rows, total = [], [], 0
    for name, machine, graph in device_ga_apps():
        runs = []
        for _ in range(2):
            ops.sim_relax_pop.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vec, val = ga_search(graph, machine, seed=0, params=par)
            torch.cuda.synchronize()
            runs.append((vec, val, time.perf_counter() - t0,
                         ops.sim_relax_pop.launches))
        (v1, f1, wall1, n1), (v2, f2, wall2, n2) = runs
        if not (np.array_equal(v1, v2) and f1 == f2):
            fail(f"device GA {name}: two runs with seed 0 differ "
                 f"({f1!r} vs {f2!r})")
        inp, rv, rf, pop, fit, rounds = replay_device_ga(graph, machine,
                                                         par, dev)
        if not (np.array_equal(rv, v1) and rf == f1):
            fail(f"device GA {name}: the loop replayed by hand ends at "
                 f"{rf!r}, the search at {f1!r}")
        if not 0 <= rounds <= par.refine_rounds:
            fail(f"device GA {name}: {rounds} refine rounds, not within "
                 f"0..{par.refine_rounds}")
        for n in (n1, n2):
            if n != 1 + par.generations + rounds:
                fail(f"device GA {name}: {n} sim_relax_pop launches, not "
                     f"1 + {par.generations} + {rounds} refine rounds")
        total += n1 + n2
        kern = device.population_fitness_device(inp, pop, method="kernel")
        scan = device.population_fitness_device(inp, pop, method="scan")
        torch.cuda.synchronize()
        if not (torch.equal(kern, scan) and torch.equal(kern, fit)):
            fail(f"device GA {name}: kernel fitness != scan fitness on the "
                 f"final population")
        sch = decode(graph, machine, v1, gap_fill=False)
        f64 = simulate_batch(lower_population(graph, machine, [sch]),
                             backend="numpy").t_exec[0]
        if not abs(f1 - f64) <= RTOL_F32 * abs(f64):
            fail(f"device GA {name}: winner fitness {f1!r} vs float64 "
                 f"append-only decode {f64!r}")
        eng = get_scheduler("engine")(graph, machine)
        ga_sch = ga_schedule(graph, machine, seed=0, params=par)
        validate(ga_sch, graph, machine, require_task_coherence=True)
        if ga_sch.makespan() > eng.makespan() + 1e-9:
            fail(f"device GA {name}: ga_schedule {ga_sch.makespan()!r} > "
                 f"engine {eng.makespan()!r}")
        # one generation in isolation, and the host GA for comparison
        step = device.generation_step(par, n_tasks=len(graph.tasks),
                                      n_cores=machine.n_cores,
                                      method="kernel")
        gen = torch.Generator(device=dev).manual_seed(1)
        gpop, gfit = step(inp, gen, pop, fit)      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            gpop, gfit = step(inp, gen, gpop, gfit)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3 / 10
        t0 = time.perf_counter()
        _, host_val = ga_search(graph, machine, seed=0,
                                params=GAParams(backend="cuda"))
        host_s = time.perf_counter() - t0
        rows.append(dict(name=name, S=graph.n_subtasks,
                         tasks=len(graph.tasks), cores=machine.n_cores,
                         fitness=f1, fitness_f64_appendonly=f64,
                         refine_rounds=rounds, launches=[n1, n2],
                         search_s=[wall1, wall2], ms_per_generation=gen_ms,
                         host_ga_s=host_s, host_ga_fitness=host_val,
                         ga_schedule=ga_sch.makespan(),
                         engine=eng.makespan()))
        print("device ga " + json.dumps(rows[-1]))
        args = [x.contiguous() for x in
                device.population_gather_inputs(inp, pop)]
        pop_rows.append(sim_row(f"device-ga-{name}{shapes(args[:1])[0]}",
                                args, inp.n_subtasks, ops,
                                sim_relax_pop_cuda, sim_relax_pop_torch))
        print("sim_relax_pop " + json.dumps(pop_rows[-1]))
    return total, pop_rows


def verify_phase(dev, runs):
    """``verify=True`` on the 64core suites (the kernel) and on the
    engine scheduler; a result with one finish time moved before its
    predecessor's must raise ``VerifyError``."""
    import dataclasses

    import numpy as np

    from repro_torch.analysis import VerifyError, verify_batch_result
    from repro_torch.core import (batch_scenarios, get_scheduler,
                                  lower_scenario, simulate_batch,
                                  simulate_suite)
    from repro_torch.kernels import ops

    ops.sim_relax_pop.launches = 0
    for r in runs:
        if r["name"].startswith("64core"):
            simulate_suite(r["graphs"], r["machine"], r["schedules"],
                           jitter=r["jitter"], seeds=r["seeds"],
                           backend="cuda", device=dev, verify=True)
    launches = ops.sim_relax_pop.launches
    if launches == 0:
        fail("verify: the 64core suites never launched sim_relax_pop")
    r = runs[0]
    sch = get_scheduler("engine", verify=True)(r["graphs"][0], r["machine"])
    batch = batch_scenarios([lower_scenario(r["graphs"][0], r["machine"],
                                            sch)])
    res = simulate_batch(batch, backend="cuda", device=dev, verify=True)
    s = batch.max_subtasks
    i = int(np.argmax(batch.pred[0, :, 0] < s))      # first with a pred
    q = int(batch.pred[0, i, 0])
    end = np.array(res.subtask_end)
    end[0, i] = end[0, q] - 1.0                      # before its pred ends
    bad = dataclasses.replace(res, subtask_end=end)
    try:
        verify_batch_result(batch, bad, rtol=RTOL_F32)
    except VerifyError as err:
        print(f"verify: corrupted result rejected ({sorted(err.kinds)})")
    else:
        fail("verify: a finish time moved before its predecessor's passed")
    print(f"verify: 64core suites and the engine schedule proven on the "
          f"card ({launches} sim_relax_pop launches)")
    return launches


#: each tracecheck entry's kernel launches per call on the card
TRACE_LAUNCHES = {"search.generation_step": {"sim_relax_pop": 1},
                  "sim.relax_pop": {"sim_relax_pop": 1},
                  "kernels.sched_score": {"sched_score": 1},
                  "online.admission_score": {"sched_score": 1},
                  "kernels.flash_attention": {"flash_attention": 1}}


def analysis_phase(dev):
    """The port's lint over its tree and its tracecheck (``--quick``) on
    the card over the manifest; any finding fails. Each entry must launch
    its kernel once per call, and the admission scorer must read back
    exactly once per call."""
    from repro_torch.analysis import lint, tracecheck
    bad = lint.lint_paths(lint.default_paths())
    print(f"lint: {len(bad)} finding(s) over the port's tree")
    if bad:
        fail("lint: " + "; ".join(str(v) for v in bad))
    t0 = time.perf_counter()
    reports = tracecheck.run_tracecheck(quick=True, device=dev)
    for r in reports:
        print("tracecheck " + json.dumps(r.row()))
    print(f"tracecheck: {len(reports)} entries on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    bad = [str(v) for r in reports for v in r.violations]
    if bad:
        fail("tracecheck: " + "; ".join(bad))
    by = {r.entry: r for r in reports}
    if set(by) != set(TRACE_LAUNCHES):
        fail(f"tracecheck ran {sorted(by)}, not {sorted(TRACE_LAUNCHES)}")
    for name, want in TRACE_LAUNCHES.items():
        if by[name].launches != want:
            fail(f"tracecheck {name}: launches {by[name].launches}, "
                 f"expected {want}")
    syncs = by["online.admission_score"].host_syncs
    if len(syncs) != 1:
        fail(f"admission scorer: {len(syncs)} host read-backs per call "
             f"({syncs}), expected exactly 1")


# -- 12. the paper's evaluation: T_est, and T_exec from the event
#        simulator, the batched simulator on the card and the threaded
#        executor; 13. MoE and MLA serving --------------------------------

PAPER_SUITES = (("8core", 20, 0, 4.0), ("64core", 8, 100, 6.0))  # band %
EXEC_SCALE = 1e-3                   # model seconds -> wall seconds


def dif_row(name, difs, band):
    """n, mean, max and min %Dif_rel of one source beside the paper's
    band (|%Dif| below it), as ``benchmarks/paper_tables.py`` reports."""
    import numpy as np
    d = np.asarray(difs, dtype=float)
    return dict(source=name, n=int(d.size), mean=float(d.mean()),
                max=float(d.max()), min=float(d.min()), band=band,
                within_band=bool((np.abs(d) < band).all()))


def paper_phase(dev):
    """The paper's 8-core suite (20 apps of 15-25 tasks, seed 0) on
    ``dell_poweredge_1950`` and its 64-core suite (8 apps, seed 100) on
    ``hp_bl260c``, mapped by ``get_scheduler("engine")`` (T_est = the
    makespan). T_exec from three sources: the contention-aware event
    simulator (jitter 0.01, seed i), ``simulate_suite(backend="cuda")``
    (``sim_relax_pop``, jitter 0.01) and ``execute_threaded`` at
    ``time_scale`` 1e-3, wall-clock. Checks: each threaded T_exec >=
    T_est, its T_exec == wall_seconds / time_scale, ``dif_rel`` exactly
    Eq. 4; the batched result within rtol 1e-5 of the float64 backend;
    ``sim_relax_pop`` launched. The band is printed, not gated: the
    threaded T_exec is wall-clock on a shared host. Returns the kernel's
    launches."""
    import numpy as np

    from repro_torch.core import (dell_poweredge_1950, execute_threaded,
                                  get_scheduler, hp_bl260c,
                                  paper_suite_8core, paper_suite_64core,
                                  simulate, simulate_suite)
    from repro_torch.kernels import ops

    mapper = get_scheduler("engine")
    launches = 0
    for name, n_apps, seed, band in PAPER_SUITES:
        machine, graphs = (
            (dell_poweredge_1950(), paper_suite_8core(n_apps, seed=seed))
            if name == "8core" else
            (hp_bl260c(), paper_suite_64core(n_apps, seed=seed)))
        t0 = time.perf_counter()
        schedules = [mapper(g, machine) for g in graphs]
        map_s = time.perf_counter() - t0
        t_est = [s.makespan() for s in schedules]
        seeds = list(range(len(graphs)))
        event = [simulate(g, machine, s, contention=True, jitter=JITTER,
                          seed=i).dif_rel(t_est[i])
                 for i, (g, s) in enumerate(zip(graphs, schedules))]
        ops.sim_relax_pop.launches = 0
        batched = simulate_suite(graphs, machine, schedules, jitter=JITTER,
                                 seeds=seeds, backend="cuda", device=dev)
        launches += ops.sim_relax_pop.launches
        if ops.sim_relax_pop.launches == 0:
            fail(f"paper {name}: simulate_suite never launched "
                 f"sim_relax_pop")
        f64 = simulate_suite(graphs, machine, schedules, jitter=JITTER,
                             seeds=seeds, backend="numpy")
        if not np.allclose(batched.subtask_end, f64.subtask_end,
                           rtol=RTOL_F32, atol=0.0):
            fail(f"paper {name}: batched T_exec off the float64 backend "
                 f"beyond rtol {RTOL_F32}")
        t0 = time.perf_counter()
        threaded = [execute_threaded(g, machine, s, time_scale=EXEC_SCALE)
                    for g, s in zip(graphs, schedules)]
        exec_s = time.perf_counter() - t0
        for i, (r, est) in enumerate(zip(threaded, t_est)):
            if not r.t_exec >= est:
                fail(f"paper {name} app {i}: threaded T_exec {r.t_exec!r} "
                     f"below T_est {est!r}")
            if r.t_exec != r.wall_seconds / EXEC_SCALE:
                fail(f"paper {name} app {i}: T_exec {r.t_exec!r} is not "
                     f"wall_seconds {r.wall_seconds!r} / {EXEC_SCALE}")
            if r.dif_rel(est) != (r.t_exec - est) / r.t_exec * 100.0:
                fail(f"paper {name} app {i}: dif_rel is not Eq. 4")
        rows = [dif_row("event", event, band),
                dif_row("batched_cuda", batched.dif_rel(), band),
                dif_row("threaded", [r.dif_rel(e) for r, e in
                                     zip(threaded, t_est)], band)]
        for row in rows:
            print(f"paper {name} %Dif_rel " + json.dumps(row))
        print(f"paper {name}: machine={machine.name!r} apps={len(graphs)} "
              f"subtasks={sum(g.n_subtasks for g in graphs)} "
              f"map_s={map_s:.3f} executor_wall_s={exec_s:.3f} (sum of "
              f"T_exec x time_scale "
              f"{sum(r.wall_seconds for r in threaded):.3f}) "
              f"sim_relax_pop launches {ops.sim_relax_pop.launches}")
    return launches


MOE_RUN_B = dict(batch=1, prompt=4096, gen=16)   # runs A and C: gemma2's
QWEN3_LAYERS = 8                    # of 94: about 42 GB in bf16, one card


@contextlib.contextmanager
def recorded_routes(forced=None):
    """Every ``router_topk`` call's ids (T, k), in call order, while the
    block runs. With ``forced`` (a list of ids from another run of the
    same calls) call i takes the experts ``forced[i]`` instead of its own
    top-k: its weights are its own float32 softmax probabilities at those
    ids, renormalised, its aux loss the Switch loss over them, as
    ``router_topk`` computes both."""
    import torch

    from repro_torch.models import moe
    calls = []
    real = moe.router_topk

    def router_topk(x, w_router, top_k):
        out = real(x, w_router, top_k)
        if forced is not None:
            ids = forced[len(calls)]
            probs = torch.softmax(torch.einsum(
                "td,de->te", x.float(), w_router.float()), dim=-1)
            w = probs.gather(1, ids)
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            ce = torch.bincount(ids.reshape(-1), minlength=probs.shape[1]) \
                .float() / ids.numel()
            out = (w, ids, probs.shape[1] * torch.sum(probs.mean(0) * ce))
        calls.append(out[1])
        return out
    moe.router_topk = router_topk
    try:
        yield calls
    finally:
        moe.router_topk = real


def routes_by_position(calls, n_moe, b, s, n):
    """``recorded_routes`` of a ``teacher_forced`` run (one prefill of
    (B, S) tokens, then n - 1 decode steps) as (B, S + n - 1, layers, k)
    sorted ids: token position by MoE layer."""
    import torch
    if len(calls) != n_moe * n:
        fail(f"router called {len(calls)} times, expected {n_moe} layers "
             f"x {n} forwards")
    pre = torch.stack([c.reshape(b, s, -1) for c in calls[:n_moe]], dim=2)
    dec = [torch.stack([c.reshape(b, 1, -1) for c in
                        calls[n_moe * (i + 1):n_moe * (i + 2)]], dim=2)
           for i in range(n - 1)]
    return torch.cat([pre] + dec, dim=1).sort(dim=-1).values


def check_teacher_forced_routed(label, cfg, params, prompt, toks, ops, rel,
                                greedy=True):
    """``teacher_forced`` logits of the kernel path against the plain
    path (the three entry points swapped for their plain versions), with
    each MoE layer's chosen experts recorded on both.

    Routing is discrete: a rounding difference can send a token to other
    experts, and a token sent elsewhere changes every later token through
    attention. So the plain path runs twice. On its own routes it gives
    the share of (token, layer) routes that differ (overall and by
    layer), the share of positions held (the logits' position and every
    token before it routed alike on every layer) and the largest logit
    difference at a held position: printed. On the kernel path's routes
    (``recorded_routes(forced=...)``: the same experts, the plain path's
    own router weights at them) every position is routed alike by
    construction, and the gate holds the logits within ``rel`` of the
    largest logit at every position: the kernels against their plain
    versions through the whole MoE model."""
    import torch
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
    b, s = prompt.shape
    n = toks.shape[1]
    with recorded_routes() as rk:
        kern = teacher_forced(cfg, params, prompt, toks)
    if not torch.isfinite(kern).all():
        fail(f"{label}: non-finite logits on the kernel path")
    if greedy and not torch.equal(kern.argmax(-1), toks):
        fail(f"{label}: re-running the kernel path gave other greedy tokens")
    with plain_serving_kernels(ops), recorded_routes() as rp:
        plain = teacher_forced(cfg, params, prompt, toks)
    with plain_serving_kernels(ops), recorded_routes(forced=rk) as rf:
        forced = teacher_forced(cfg, params, prompt, toks)
    route_k = routes_by_position(rk, n_moe, b, s, n)
    if not torch.equal(routes_by_position(rf, n_moe, b, s, n), route_k):
        fail(f"{label}: the forced plain run did not take the kernel "
             f"path's routes")
    differ = (route_k != routes_by_position(rp, n_moe, b, s, n)).any(-1)
    # logits position 0 is the prompt's last token's, i the i-th fed
    # token's; each depends on every token up to its own
    moved = differ.any(-1).cumsum(1) > 0             # (B, S + n - 1)
    same = ~moved[:, s - 1:]                         # (B, n)
    d = (kern - plain).abs().amax(-1)                # (B, n)
    scale = float(plain.abs().max())
    d_forced = float((kern - forced).abs().max())
    out = dict(positions=int(same.numel()), routes=int(differ.numel()),
               route_differ_share=float(differ.float().mean()),
               route_differ_share_by_layer=[
                   round(float(x), 5) for x in differ.float().mean((0, 1))],
               held=float(same.float().mean()),
               max_dlogit_held=float(d[same].max()) if same.any() else None,
               max_dlogit_own_routes=float(d.max()),
               max_dlogit_forced_routes=d_forced, bound=rel * scale,
               max_logit=scale,
               top1_forced=float((kern.argmax(-1) == forced.argmax(-1))
                                 .float().mean()))
    print(f"{label} teacher-forced ({cfg.dtype}) " + json.dumps(out))
    if not d_forced <= rel * scale:
        fail(f"{label}: kernel path logits off the plain path's on the "
             f"same routes by {d_forced:.4e} > {rel * scale:.4e}")
    return out


def weight_read_bound(params):
    """What one decode step must read at least: every weight but the
    embedding table (only its B rows are gathered), and of them the
    routed experts, in bytes and in ms at the memory rate."""
    every = sum(p.numel() * p.element_size()
                for name, p in params.named_parameters() if name != "embed")
    experts = sum(p.numel() * p.element_size()
                  for name, p in params.named_parameters()
                  if ".moe.w" in name)
    return dict(weight_bytes=every, expert_bytes=experts,
                bound_ms=every / HBM_BYTES_PER_S * 1e3,
                expert_bound_ms=experts / HBM_BYTES_PER_S * 1e3)


def moe_phase(dev):
    """Serve deepseek-v2-lite-16b whole (runs A, B, C) and
    qwen3-moe-235b-a22b at full width cut to 8 layers (run A) in bf16,
    check them and time them. Returns, per serving kernel, its counts by
    run and its largest error against the plain version here."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import decode_plan
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ShardCtx()
    keys = spy_keys()
    launches = {}

    def load(cfg, dtype="bfloat16"):
        cfg = cfg.replace(dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        size = sum(p.numel() * p.element_size() for p in params.parameters())
        print(f"moe: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
              f"heads={cfg.n_heads}/{cfg.n_kv_heads} experts="
              f"{cfg.n_experts} top-{cfg.top_k} of {cfg.d_ff_expert} "
              f"shared={cfg.n_shared_experts} kv_lora={cfg.kv_lora_rank} "
              f"{cfg.dtype} params={n_params} ({size / 1e9:.2f} GB) "
              f"init_s={time.perf_counter() - t0:.1f}")
        generate(cfg, ctx, params, {"tokens": torch.randint(
            0, cfg.vocab, (1, 16), generator=gen, device=dev)}, 2)  # warm-up
        torch.cuda.synchronize()
        return cfg, gen, params

    def want_of(cfg):
        norms = 2 + bool(cfg.kv_lora_rank) + 2 * cfg.qk_norm
        n = cfg.n_layers

        def want(n_pre, n_dec):
            return {"rmsnorm": (n_pre + n_dec) * (norms * n + 1),
                    "flash_attention": n_pre * n,
                    "flash_decode": 0 if cfg.kv_lora_rank else n_dec * n}
        return want

    def freed(label):
        """Print the model's peak device memory once its last reference
        is gone, and give its memory back before the next is built."""
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label} peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SERVE_KERNELS}

        # -- deepseek-v2-lite-16b, whole: runs A, B, C -----------------------
        cfg, gen, params = load(ARCHS["deepseek-v2-lite-16b"])
        prompt_a = torch.randint(0, cfg.vocab, (RUN_A["batch"],
                                                RUN_A["prompt"]),
                                 generator=gen, device=dev)
        prompt_b = torch.randint(0, cfg.vocab, (MOE_RUN_B["batch"],
                                                MOE_RUN_B["prompt"]),
                                 generator=gen, device=dev)
        reqs = ragged_requests(cfg.vocab)
        runs = {}
        for name, run, prompt, rq in (("A", RUN_A, prompt_a, None),
                                      ("B", MOE_RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[f"deepseek_{name}"] = drive(
                "deepseek", name, run, cfg, params, spies, want_of(cfg),
                prompt=prompt, reqs=rq)
        if any(launches[f"deepseek_{r}"]["flash_decode"] for r in runs):
            fail("deepseek: the MLA decode launched flash_decode")
        check_teacher_forced_routed("deepseek run A", cfg, params, prompt_a,
                                    runs["A"]["out"], ops, LOGIT_REL)
        check_batched_equals_alone("deepseek", cfg, params, reqs, dev)
        decode_breakdown("deepseek run A shape", cfg, params, prompt_a,
                         RUN_A["gen"], weight_read_bound(params))
        del params
        freed("deepseek")

        # float32, cut to 4 layers (the dense layer and 3 MoE)
        print("reduced: deepseek float32 check n_layers 27 -> 4 (the dense "
              "layer and 3 MoE layers)")
        cfg4, _, params = load(cfg.replace(n_layers=4), dtype="float32")
        check_teacher_forced_routed(
            "deepseek float32 4 layers run A", cfg4, params, prompt_a,
            runs["A"]["out"], ops, F32_LOGIT_REL, greedy=False)
        del params
        freed("deepseek float32")

        # -- qwen3-moe-235b-a22b at full width, cut in depth: run A ----------
        full = ARCHS["qwen3-moe-235b-a22b"]
        print(f"reduced: n_layers {full.n_layers} -> {QWEN3_LAYERS} (one "
              f"80 GB card)")
        cfg, gen, params = load(full.replace(n_layers=QWEN3_LAYERS))
        prompt_q = torch.randint(0, cfg.vocab, (RUN_A["batch"],
                                                RUN_A["prompt"]),
                                 generator=gen, device=dev)
        _, launches["qwen3_A"] = drive("qwen3", "A", RUN_A, cfg, params,
                                       spies, want_of(cfg), prompt=prompt_q)
        decode_breakdown("qwen3 run A shape", cfg, params, prompt_q,
                         RUN_A["gen"], weight_read_bound(params))
        del params
        freed("qwen3")

    max_err = check_against_plain("moe", spies, plain_versions(),
                                  stress_cases(gen, dev), ops)
    norm_rows_by_width("moe", spies["rmsnorm"])
    # flash_attention at each prefill shape of runs A and B (MLA's D 192
    # against Dv 128; qwen3's GQA 64/4 of 128) beside causal
    # scaled_dot_product_attention, which accepts Dv != D
    prefills = {(r["batch"], r["prompt"]) for r in (RUN_A, MOE_RUN_B)}
    for (q, k, v), akw in spies["flash_attention"].calls.values():
        if q.dtype == torch.bfloat16 and tuple(q.shape[:2]) in prefills:
            def library(q=q, k=k, v=v, scale=akw.get("scale")):
                return sdpa(q, k, v, None, True, scale)
            row = attention_row(q, k, v, akw, library)
            print("moe flash_attention " + json.dumps(
                {k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    for (q, kc, vc, pos), dkw in spies["flash_decode"].calls.values():
        if q.shape[0] == RUN_A["batch"] and q.dtype == torch.bfloat16:
            plan = decode_plan(q.shape[0], kc.shape[1], kc.shape[2],
                               q.shape[2], dv=vc.shape[-1],
                               g=q.shape[1] // kc.shape[2])
            row = decode_row(q, kc, vc, pos, dkw)
            row["plan"] = plan._asdict()
            print("moe flash_decode " + json.dumps(
                {k_: v_ for k_, v_ in row.items() if k_ != "args"}))
            break
    by_run = {k: {r: launches[r][k] for r in launches}
              for k in SERVE_KERNELS}
    return by_run, max_err


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
    from repro_torch.kernels.sched_score import (sched_score_torch,
                                                 vector_path)
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
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for k in built.values():
        for line in k.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(k.path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        print(f"  {k.name}: {sass.count('HGMMA')} HGMMA instructions in "
              f"the SASS (cuobjdump -sass)")

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
        score_calls = stack.enter_context(Timed(
            BatchedPolicy, "order_batch",
            keep=lambda pol, batch, eng, now: (pol, list(batch),
                                               FrozenEngine(eng), now)))
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
        fused, mins = ops.sched_score(*args, row_min=True)
        want, want_min = sched_score_torch(*args, row_min=True)
        torch.cuda.synchronize()
        if not (same_scores(got, want) and same_scores(fused, want)):
            fail(f"sched_score {name}: kernel != plain version")
        if not same_scores(mins, want_min):
            fail(f"sched_score {name}: row minima != the plain version's")
        vec = vector_path(args[0], args[1], fused)
        if vec != (args[0].shape[1] % 4 == 0):
            fail(f"sched_score {name}: 16-byte path {vec} at C="
                 f"{args[0].shape[1]}")
        if name.startswith("nan"):
            if not torch.isnan(want_min).any():
                fail("sched_score: the NaN stress has no NaN minimum")
            continue
        score_err = max(score_err, (got - want).abs().max().item(),
                        (mins - want_min).abs().max().item())
    score_rows = []
    for (dshape, _, _), (args, _) in score_spy.calls.items():
        score_rows.append(score_row(args))
        print("sched_score " + json.dumps(score_rows[-1]))
    # admission's host time per batch (4 batches of 16 apps), replayed on
    # the frozen inputs of each batch
    calls = [c for c in score_calls.kept if c[0].scorer == "kernel"]
    host_ms = kernel_scores_host_ms(calls)
    print("kernel_scores host ms per batch after drain_matrix "
          + json.dumps(host_ms))
    for row in score_rows:
        row["kernel_scores_host_ms"] = host_ms

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

    dense_entry = dense_phase(dev, runs)
    gc.collect()
    torch.cuda.empty_cache()
    ga_launches, ga_rows = device_ga_phase(dev)
    kernel_rows.extend(ga_rows)
    verify_launches = verify_phase(dev, runs)

    serve_rows = serve_phase(dev)
    gc.collect()                    # gemma2's weights go before the next
    torch.cuda.empty_cache()
    ssd_entry, ssm_launches, ssm_err = ssm_phase(dev)
    for row in serve_rows:
        name = row["name"]
        row["launches"] += sum(ssm_launches[name].values())
        row["launches_by_path"].update(ssm_launches[name])
        row["max_abs_err"] = max(row["max_abs_err"], ssm_err[name])

    analysis_phase(dev)
    paper_launches = paper_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_err = moe_phase(dev)
    for row in serve_rows:
        name = row["name"]
        row["launches"] += sum(moe_launches[name].values())
        row["launches_by_path"].update(moe_launches[name])
        row["max_abs_err"] = max(row["max_abs_err"], moe_err[name])

    # the device GA's largest shape: where the path spends its launches
    main_row = max((r for r in kernel_rows
                    if r["name"].startswith("device-ga")),
                   key=lambda x: x["bytes"])
    main_score = max(score_rows, key=lambda x: x["bytes"])
    print(json.dumps({"kernels": [dict(
        name="sim_relax_pop", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_relax_pop.cu",
        replaces="src/repro/kernels/sim_step.py:184",
        launches=launches["sim_relax_pop"]
        + online_launches["sim_relax_pop"] + ga_launches + verify_launches
        + paper_launches,
        launches_by_path={"offline": launches["sim_relax_pop"],
                          "online": online_launches["sim_relax_pop"],
                          "device_ga": ga_launches,
                          "verify": verify_launches,
                          "paper": paper_launches},
        max_abs_err=max(x["max_abs_err"] for x in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"], k=main_row["k"],
        variant=main_row["variant"], sweeps_max=main_row["sweeps_max"],
        sweeps_median=main_row["sweeps_median"],
        n_steps=main_row["depth"]), dict(
        name="sched_score", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_score.cu",
        replaces="src/repro/kernels/sched_score.py:47",
        launches=online_launches["sched_score"],
        launches_by_path={"offline": launches["sched_score"],
                          "online": online_launches["sched_score"]},
        max_abs_err=score_err, ms=main_score["ms"],
        plain_ms=main_score["plain_ms"], bound_ms=main_score["bound_ms"],
        bound_by=main_score["bound_by"], library_ms=None,
        shape=main_score["name"], floor_ms=main_score["floor_ms"],
        eager_ms=main_score["eager_ms"],
        kernel_scores_host_ms=main_score["kernel_scores_host_ms"]),
        dense_entry] + serve_rows
        + [ssd_entry]}))

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
