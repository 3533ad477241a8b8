"""Array-backed discrete-event simulation over the ScenarioArrays IR.

Two execution paths, both fed by :mod:`repro_torch.core.lowering`:

* :func:`simulate_arrays` — the seed ``simulate()`` event loop ported
  onto the IR: the same event heap, the same fluid bandwidth sharing
  per memory-level instance, the same jitter draws in the same order —
  every float operation reproduces the seed's expression shape, so
  deterministic runs match **bit for bit** (``tests/test_sim_engine.py``
  pins it). Object-graph chasing (``graph.subtasks[sid].time_on`` /
  ``machine.level_index`` / schedule dict hops) is replaced by plain
  row-list lookups off the lowered arrays.
* :func:`simulate_batch` — the whole-suite path: a fixed-shape
  synchronous relaxation that evaluates every ``(app × machine ×
  jitter)`` scenario of a :class:`~repro_torch.core.lowering.ScenarioBatch`
  at once. One sweep updates every subtask's finish time as

      end[s] = exec[s] + max(release[s], end[prev_on_core(s)],
                             max_j (end[pred_j] + lat_j) + vol_j/bw_j)

  which is exactly the analytic (``contention=False``) semantics of the
  event simulator — after ``batch.depth`` sweeps (the longest path of
  deps ∪ in-order edges) every value is final. Contention is a fluid,
  time-coupled process and stays on the per-scenario event path; the
  batched path is the throughput validator.
  ``backend="cuda"`` runs the same sweep as the hand-written CUDA
  kernel ``sim_relax_pop`` (``kernels/csrc/sim_relax_pop.cu``) on padded
  (B, S, P+1) predecessor gathers in float32 — O(B·S·P) memory, so
  1k+-subtask suites fit; ``backend="torch"`` runs its plain PyTorch
  version, ``backend="numpy"`` the float64 wave-ordered pass.
  :func:`relax_batch_np` is the float64 synchronous (Jacobi) sweep over
  the same batch, the reference of the dense ``sim_step`` kernel
  (``kernels/csrc/sim_step.cu``, fed by
  :func:`~repro_torch.core.lowering.dense_lags`).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from ..kernels.sim_step import sim_relax_pop_torch
from .lowering import (ScenarioArrays, ScenarioBatch, batch_scenarios,
                       lower_scenario)
from .machine import MachineModel
from .mpaha import AppGraph
from .simulator import SimResult


# ---------------------------------------------------------------------------
# exact per-scenario event simulation (contention + jitter + releases)
# ---------------------------------------------------------------------------

def _machine_views(ma) -> tuple:
    """Python-list views of the machine arrays (plain-float arithmetic
    is ~5x cheaper than np scalar ops in the event loop), cached on the
    frozen MachineArrays and shared by every scenario on the machine."""
    v = ma.__dict__.get("_py_views")
    if v is None:
        v = (ma.lat.tolist(), ma.bw.tolist(), ma.pair_instance.tolist(),
             ma.inst_lat.tolist(), ma.inst_bw.tolist())
        object.__setattr__(ma, "_py_views", v)
    return v


def _scenario_views(sa: ScenarioArrays) -> tuple:
    """Per-scenario list views (exec rows, succ adjacency, core order,
    pred counts, releases), cached on the frozen ScenarioArrays."""
    v = sa.__dict__.get("_py_views")
    if v is None:
        n_sub = sa.graph.n_subtasks
        pp = sa.graph.pred_ptr.tolist()
        spl = sa.graph.succ_ptr.tolist()
        ssl = sa.graph.succ_sid.tolist()
        svl = sa.graph.succ_vol.tolist()
        opl = sa.order_ptr.tolist()
        v = (sa.exec_core.tolist(),
             sa.core_of.tolist(),
             [list(zip(ssl[spl[s]:spl[s + 1]], svl[spl[s]:spl[s + 1]]))
              for s in range(n_sub)],
             [pp[s + 1] - pp[s] for s in range(n_sub)],
             [sa.order_sid[opl[c]:opl[c + 1]].tolist()
              for c in range(sa.machine.n_cores)],
             sa.release.tolist(),
             sa.release_order.tolist())
        object.__setattr__(sa, "_py_views", v)
    return v


def _fault_views(fa) -> tuple:
    """Python-list fail times (slow/degrade are already plain tuples),
    cached on the frozen FaultArrays."""
    v = fa.__dict__.get("_py_views")
    if v is None:
        v = (fa.fail_t.tolist(), fa.slow, fa.degrade)
        object.__setattr__(fa, "_py_views", v)
    return v


def simulate_arrays(sa: ScenarioArrays, *, contention: bool = True,
                    jitter: float = 0.0, seed: int = 0) -> SimResult:
    """Execute one lowered scenario exactly like the seed ``simulate``.

    Release floors come from ``sa.release`` (the lowering folds the
    seed's ``releases`` dict into the IR); they enter the event heap in
    the dict's insertion order (``sa.release_order``), so same-instant
    release ties break exactly like the seed's. ``sa.fault`` replays a
    fault script with the seed simulator's exact semantics (same
    expressions, same order — bit-identical degraded runs)."""
    rng = np.random.default_rng(seed)
    n_cores = sa.machine.n_cores
    n_sub = sa.graph.n_subtasks

    lat_rows, bw_rows, pair_rows, inst_lat, inst_bw = _machine_views(sa.machine)
    exec_rows, core_of, succs, pred_count, order, releases, release_order = \
        _scenario_views(sa)
    fa = sa.fault
    fail_t, slow_ev, degrade_ev = \
        _fault_views(fa) if fa is not None else (None, None, None)

    core_order = order                          # read-only in the loop
    core_pos = [0] * n_cores
    core_busy_until = [0.0] * n_cores
    arrivals_pending = list(pred_count)
    done: dict[int, float] = {}

    # fluid transfers: tid -> [bytes_left, instance_id, dst_sid, latency_left]
    transfers: dict[int, list] = {}
    inst_count = [0] * sa.machine.n_instances
    next_tid = 0

    events: list[tuple[float, int, str, int]] = []
    seq = 0
    now = 0.0

    def exec_time(sid: int, core: int) -> float:
        base = exec_rows[sid][core]
        if slow_ev is not None:
            # slowdown sampled at the start instant, factors composed
            # in script order (the bit-identity contract of the script)
            for t_ev, f_ev in slow_ev[core]:
                if now >= t_ev:
                    base *= f_ev
        if jitter > 0.0:
            base *= float(np.exp(rng.normal(0.0, jitter)))
        return base

    def try_start(core: int) -> None:
        nonlocal seq
        if core_pos[core] >= len(core_order[core]):
            return
        if fail_t is not None and now >= fail_t[core]:
            return                          # dead core: strand the rest
        sid = core_order[core][core_pos[core]]
        if arrivals_pending[sid] > 0 or core_busy_until[core] > now + 1e-15:
            return
        dur = exec_time(sid, core)
        core_pos[core] += 1
        core_busy_until[core] = now + dur
        heapq.heappush(events, (now + dur, seq, "done", sid))
        seq += 1

    def arrive(sid_dst: int) -> None:
        arrivals_pending[sid_dst] -= 1
        if arrivals_pending[sid_dst] == 0:
            try_start(core_of[sid_dst])

    def start_transfer(src: int, dst: int, vol: float) -> None:
        nonlocal next_tid, seq
        a, b = core_of[src], core_of[dst]
        if a == b or vol <= 0.0:
            arrive(dst)
            return
        # link degradation sampled at the transfer's start; multiplying
        # by the neutral 1.0 is exact, so fault-free runs are unchanged
        lp = 1.0
        if degrade_ev:
            steps = degrade_ev.get((a, b) if a < b else (b, a))
            if steps:
                for t_ev, f_ev in steps:
                    if now >= t_ev:
                        lp *= f_ev
        if not contention:
            heapq.heappush(events,
                           (now + lat_rows[a][b] * lp
                            + vol / bw_rows[a][b] * lp,
                            seq, "arrive", dst))
            seq += 1
            return
        inst = pair_rows[a][b]
        transfers[next_tid] = [vol * lp, inst, dst, inst_lat[inst] * lp]
        inst_count[inst] += 1
        next_tid += 1

    def transfer_rate(inst: int) -> float:
        return inst_bw[inst] / max(1, inst_count[inst])

    def next_transfer_completion() -> tuple[float, int] | None:
        best = None
        for tid, (bytes_left, inst, _dst, lat) in transfers.items():
            t = now + lat + bytes_left / transfer_rate(inst)
            if best is None or t < best[0]:
                best = (t, tid)
        return best

    def advance_transfers(dt: float) -> None:
        for rec in transfers.values():
            lat_used = min(rec[3], dt)
            rec[3] -= lat_used
            fluid_dt = dt - lat_used
            if fluid_dt > 0:
                rec[0] -= fluid_dt * transfer_rate(rec[1])

    for sid in release_order:
        t_rel = releases[sid]
        if t_rel > 0.0:
            arrivals_pending[sid] += 1
            heapq.heappush(events, (t_rel, seq, "arrive", sid))
            seq += 1

    for core in range(n_cores):
        try_start(core)

    while events or transfers:
        ev = events[0] if events else None
        tr = next_transfer_completion()
        if tr is not None and (ev is None or tr[0] < ev[0]):
            t_next, tid = tr
            advance_transfers(t_next - now)
            now = t_next
            rec = transfers.pop(tid)
            inst_count[rec[1]] -= 1
            arrive(rec[2])
        else:
            assert ev is not None
            t_next, _, kind, payload = heapq.heappop(events)
            advance_transfers(t_next - now)
            now = t_next
            if kind == "done":
                sid = payload
                core = core_of[sid]
                if fail_t is not None and now > fail_t[core]:
                    # the core died while this subtask was in flight:
                    # the result is lost — no completion, no transfers,
                    # and the dead core starts nothing else
                    continue
                done[sid] = now
                for succ, vol in succs[sid]:
                    start_transfer(sid, succ, vol)
                try_start(core)
            else:
                arrive(payload)
        for core in range(n_cores):
            if core_busy_until[core] <= now + 1e-15:
                try_start(core)

    if len(done) != n_sub:
        missing = set(range(n_sub)) - set(done)
        if fa is None:
            raise RuntimeError(f"simulation deadlock; unfinished: {missing}")
        # faults legitimately strand work (dead core, or downstream of
        # one); makespan is over finished subtasks, stranded get inf
        stranded = tuple(sorted(missing))
        for s in stranded:
            done[s] = float("inf")
        return SimResult(max((done[s] for s in done if s not in missing),
                             default=0.0), done, stranded)
    return SimResult(max(done.values(), default=0.0), done)


def simulate_scenario(graph: AppGraph, machine: MachineModel, schedule,
                      contention: bool = True, jitter: float = 0.0,
                      seed: int = 0,
                      releases: dict[int, float] | None = None,
                      faults=None) -> SimResult:
    """Signature-compatible drop-in for the seed ``simulate``: lower the
    scenario, run the array event loop. Registered as the ``"arrays"``
    simulator."""
    sa = lower_scenario(graph, machine, schedule, releases=releases,
                        faults=faults)
    return simulate_arrays(sa, contention=contention, jitter=jitter,
                           seed=seed)


# ---------------------------------------------------------------------------
# batched fixed-shape relaxation (whole suites in one call)
# ---------------------------------------------------------------------------

def _gather_inputs(batch: ScenarioBatch) -> tuple[np.ndarray, np.ndarray]:
    """(B, S, P+1) gather sources and lags of the float64 wave pass —
    the in-order core edge rides as one more predecessor column
    with zero lag, indices are flattened against the ``(B, S+1)`` end
    buffer, and the per-edge lag is the prefolded ``lat + vol/bw`` (one
    add per pass; within 1 ulp of the event simulator's two-add
    expression). Cached on the batch."""
    cached = batch.__dict__.get("_gather_inputs")
    if cached is not None:
        return cached
    b, s = batch.n_scenarios, batch.max_subtasks
    idx = np.concatenate([batch.pred, batch.prev[:, :, None]], axis=2)
    idx = idx + (np.arange(b) * (s + 1))[:, None, None]
    lag = np.concatenate(
        [batch.pred_lat + batch.pred_volbw,
         np.where(batch.prev[:, :, None] < s, 0.0, -np.inf)], axis=2)
    object.__setattr__(batch, "_gather_inputs", (idx, lag))
    return idx, lag


def relax_batch_np(batch: ScenarioBatch, duration: np.ndarray | None = None,
                   n_steps: int | None = None) -> np.ndarray:
    """NumPy relaxation over the padded CSR batch: ``(B, S)`` finish
    times after ``n_steps`` synchronous sweeps (default: the batch's
    fixpoint depth). ``duration`` overrides ``batch.duration`` (the
    jitter hook). The sweep is allocation-free: gathers run through one
    flat ``np.take`` into a preallocated buffer. The float64 reference of
    the dense ``sim_step`` kernel's sweeps."""
    b, s, p = batch.n_scenarios, batch.max_subtasks, batch.max_preds
    dur = batch.duration if duration is None else duration
    steps = batch.depth if n_steps is None else n_steps
    idx, lag = _gather_inputs(batch)
    end = np.zeros((b, s + 1))                 # slot s = sentinel (always 0)
    flat = end.reshape(-1)
    gath = np.empty((b, s, p + 1))
    ready = np.empty((b, s))
    for _ in range(steps):
        np.take(flat, idx, out=gath)
        gath += lag
        gath.max(axis=2, out=ready)
        np.maximum(ready, batch.release, out=ready)
        np.maximum(ready, 0.0, out=ready)      # idle-core floor
        np.add(ready, dur, out=end[:, :s])
    return np.array(end[:, :s])


def _wave_plan(batch: ScenarioBatch):
    """Wave-ordered evaluation plan, cached on the batch: every valid
    (scenario, subtask) pair sorted by topological level, with its
    gather sources (preds + in-order edge) resolved to flat indices
    into the ``(B, S+1)`` end buffer and its lags prefolded. Segment
    ``w`` of the plan depends only on segments ``< w``, so one pass
    computes every finish time exactly once."""
    plan = batch.__dict__.get("_wave_plan")
    if plan is not None:
        return plan
    b, s, p = batch.n_scenarios, batch.max_subtasks, batch.max_preds
    idx, lag = _gather_inputs(batch)
    flat_pos = np.arange(b * s)
    valid = (flat_pos % s) < batch.n_sub.astype(np.int64)[flat_pos // s]
    order = flat_pos[valid]
    waves = batch.wave.reshape(-1)[order]
    sort = np.argsort(waves, kind="stable")
    order, waves = order[sort], waves[sort]
    # segment boundaries: one slice per wave value
    bounds = np.searchsorted(waves, np.arange(1, waves[-1] + 1 if len(waves)
                                              else 1))
    plan = (order,
            np.concatenate([[0], bounds, [len(order)]]).astype(np.int64),
            idx.reshape(b * s, p + 1)[order],
            lag.reshape(b * s, p + 1)[order],
            batch.release.reshape(-1)[order],
            # scatter target in the (B, S+1) end buffer
            (order // s) * (s + 1) + (order % s))
    object.__setattr__(batch, "_wave_plan", plan)
    return plan


def relax_wave_np(batch: ScenarioBatch,
                  duration: np.ndarray | None = None) -> np.ndarray:
    """Wave-scheduled evaluation: identical finish times to
    :func:`relax_batch_np`, the synchronous sweep's fixpoint (each
    subtask's value is computed from final predecessor values with the
    same expression) with every subtask touched exactly once instead of
    once per sweep — the float64 CPU path for large suites."""
    b, s = batch.n_scenarios, batch.max_subtasks
    dur = (batch.duration if duration is None else duration).reshape(-1)
    order, bounds, idx, lag, rel, target = _wave_plan(batch)
    dur = dur[order]
    end = np.zeros(b * (s + 1))
    for w in range(len(bounds) - 1):
        lo, hi = bounds[w], bounds[w + 1]
        if lo == hi:
            continue
        g = end[idx[lo:hi]]
        g += lag[lo:hi]
        r = g.max(axis=1)
        np.maximum(r, rel[lo:hi], out=r)
        np.maximum(r, 0.0, out=r)              # idle-core floor
        r += dur[lo:hi]
        end[target[lo:hi]] = r
    return np.array(end.reshape(b, s + 1)[:, :s])


def relax_wave_faults(batch: ScenarioBatch,
                      duration: np.ndarray | None = None) -> np.ndarray:
    """Wave-scheduled evaluation of a fault-carrying batch: the
    analytic (``contention=False``) fault semantics of the event
    simulators, vectorized. Per subtask, at its ready instant ``r``:

    * each incoming edge's lag is ``lat*lp + volbw*lp`` with ``lp`` the
      product of degrade factors triggered at the *producer's finish*
      (the transfer start — same sampling instant as the event loops);
    * the duration is scaled by ``sp``, the product of slow factors
      triggered at ``r`` (the subtask's start);
    * a finish past the core's fail instant is killed: its end becomes
      ``inf``, which propagates to every consumer through the max.

    Stranded subtasks therefore come back ``inf``, matching
    ``SimResult.subtask_end`` under faults. Fault-free scenarios inside
    a faulty batch take the same expressions with all-neutral factors
    (``x * 1.0`` is exact), so they match :func:`relax_wave_np`."""
    b, s = batch.n_scenarios, batch.max_subtasks
    dur = (batch.duration if duration is None else duration).reshape(-1)
    order, bounds, idx, lag, rel, target = _wave_plan(batch)
    dur = dur[order]
    p1 = idx.shape[1]                           # P + 1 gather columns
    k2 = batch.deg_t.shape[3]
    # split lags back out of the prefolded form: the degrade factor
    # multiplies latency and vol/bw separately (like the event loops);
    # the in-order core edge (last column) is comm-free -> neutral pad
    e_lat = np.concatenate(
        [batch.pred_lat,
         np.where(batch.prev[:, :, None] < s, 0.0, -np.inf)],
        axis=2).reshape(b * s, p1)[order]
    e_volbw = np.concatenate(
        [batch.pred_volbw,
         np.where(batch.prev[:, :, None] < s, 0.0, -np.inf)],
        axis=2).reshape(b * s, p1)[order]
    deg_t = np.concatenate(
        [batch.deg_t, np.full((b, s, 1, k2), np.inf)],
        axis=2).reshape(b * s, p1, k2)[order]
    deg_f = np.concatenate(
        [batch.deg_f, np.ones((b, s, 1, k2))],
        axis=2).reshape(b * s, p1, k2)[order]
    slow_t = batch.slow_t.reshape(b * s, -1)[order]
    slow_f = batch.slow_f.reshape(b * s, -1)[order]
    fail = batch.fail_t.reshape(-1)[order]
    end = np.zeros(b * (s + 1))
    for w in range(len(bounds) - 1):
        lo, hi = bounds[w], bounds[w + 1]
        if lo == hi:
            continue
        g = end[idx[lo:hi]]                     # producer finish times
        lp = np.where(g[:, :, None] >= deg_t[lo:hi],
                      deg_f[lo:hi], 1.0).prod(axis=2)
        lagged = g + (e_lat[lo:hi] * lp + e_volbw[lo:hi] * lp)
        r = lagged.max(axis=1)
        np.maximum(r, rel[lo:hi], out=r)
        np.maximum(r, 0.0, out=r)              # idle-core floor
        sp = np.where(r[:, None] >= slow_t[lo:hi],
                      slow_f[lo:hi], 1.0).prod(axis=1)
        e = r + dur[lo:hi] * sp
        # completes iff end <= fail instant; a start at/after it can
        # never finish by it (dur > 0), so one cutoff covers both the
        # in-flight kill and the dead-core start guard
        end[target[lo:hi]] = np.where(e > fail[lo:hi], np.inf, e)
    return np.array(end.reshape(b, s + 1)[:, :s])


@dataclass(frozen=True)
class BatchSimResult:
    """Whole-suite simulation outcome (analytic semantics + jitter)."""

    t_exec: np.ndarray              # (B,)
    subtask_end: np.ndarray         # (B, S) padded; invalid slots are 0
    t_est: np.ndarray               # (B,) the schedules' makespans
    n_sub: np.ndarray               # (B,)

    def dif_rel(self) -> np.ndarray:
        """Paper Eq. (4) per scenario, 0 where ``t_exec`` is 0 (empty /
        degenerate scenarios have nothing to mispredict)."""
        out = np.zeros_like(self.t_exec)
        nz = self.t_exec != 0.0
        out[nz] = (self.t_exec[nz] - self.t_est[nz]) / self.t_exec[nz] * 100.0
        return out


def _jitter_durations(batch: ScenarioBatch, jitter: float,
                      seeds) -> np.ndarray:
    if jitter <= 0.0:
        return batch.duration
    if seeds is None:
        seeds = range(batch.n_scenarios)
    seeds = list(seeds)
    if len(seeds) != batch.n_scenarios:
        raise ValueError(f"{len(seeds)} jitter seeds for "
                         f"{batch.n_scenarios} scenarios")
    dur = np.array(batch.duration)
    for i, sd in enumerate(seeds):
        n = int(batch.n_sub[i])
        rng = np.random.default_rng(sd)
        dur[i, :n] *= np.exp(rng.normal(0.0, jitter, size=n))
    return dur


BACKENDS = ("cuda", "torch", "numpy")


def check_backend(backend: str, device) -> torch.device:
    """Resolve ``device`` for ``backend``. ``"cuda"`` launches the kernel
    and so needs a CUDA device: it raises rather than run anywhere else."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
    device = torch.device(device)
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(f"backend='cuda' launches a CUDA kernel; "
                             f"device {device} is not a CUDA device")
        if not torch.cuda.is_available():
            raise RuntimeError("backend='cuda' needs a CUDA device and none "
                               "is available (backend='torch', "
                               "device='cpu' runs the plain version)")
    return device


def simulate_batch(batch: ScenarioBatch | list[ScenarioArrays], *,
                   jitter: float = 0.0, seeds=None,
                   backend: str = "cuda",
                   device: str | torch.device = "cuda",
                   verify: bool = False) -> BatchSimResult:
    """Evaluate every scenario of the batch in one fixed-shape call.

    ``seeds`` — one jitter seed per scenario (default ``range(B)``);
    the draws are per-subtask lognormal like the event simulator's, in
    sid order rather than event order (statistically identical), drawn
    on the host with NumPy so every backend sees the same durations.
    ``backend="cuda"`` (the default) launches the ``sim_relax_pop``
    kernel on ``device`` in float32; ``backend="torch"`` runs its plain
    PyTorch version on ``device``; ``backend="numpy"`` the float64 wave
    pass (``device`` unused). Fault-carrying batches take the NumPy
    fault path on every backend: the kernel sweeps plain max-plus and
    would miss the kills. ``verify=True`` lints the lowered batch before
    the sweep and proves the result after it (:mod:`repro_torch.analysis`):
    padding, release floors, in-order + dependency edges incl. comm lag,
    fault stranding propagation, recomputed makespans.
    """
    device = check_backend(backend, device)
    if not isinstance(batch, ScenarioBatch):
        batch = batch_scenarios(batch)
    if verify:
        from ..analysis.ir_lint import lint_batch
        lint_batch(batch)
    dur = _jitter_durations(batch, jitter, seeds)
    if batch.has_faults:
        end = relax_wave_faults(batch, dur)
    elif backend == "numpy":
        end = relax_wave_np(batch, dur)
    else:
        end = _relax_pop(batch, dur, backend, device)
    masked = np.where(batch.valid, end, 0.0)
    # stranded subtasks (faults) carry inf ends: the makespan is over
    # the work that finished, like SimResult under faults
    t_exec = np.where(np.isfinite(masked), masked, 0.0).max(axis=1,
                                                            initial=0.0)
    result = BatchSimResult(t_exec=t_exec, subtask_end=masked,
                            t_est=batch.t_est, n_sub=batch.n_sub)
    if verify:
        from ..analysis.verify import verify_batch_result
        # float32 sweeps (the kernel and its plain version) round each
        # relax step; 1e-5 absorbs the accumulated ulps, the float64
        # paths get the validator's 1e-9
        rtol = 1e-5 if backend != "numpy" and not batch.has_faults \
            else 1e-9
        verify_batch_result(batch, result, duration=dur, rtol=rtol)
    return result


def _pop_gather_inputs(batch: ScenarioBatch
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B, S, P+1) gather sources and split lat / volbw lags for the
    ``sim_relax_pop`` kernel, built directly in its types (int32,
    float32): the in-order core edge rides as one more zero-lag
    predecessor column, pads keep the sentinel index ``S`` with ``-inf``
    lags. Each lag is the float64 IR value rounded once to float32.
    Cached on the batch."""
    cached = batch.__dict__.get("_pop_gather_inputs")
    if cached is not None:
        return cached
    b, s, p = batch.n_scenarios, batch.max_subtasks, batch.max_preds
    pred = np.empty((b, s, p + 1), np.int32)
    lat = np.empty((b, s, p + 1), np.float32)
    volbw = np.empty((b, s, p + 1), np.float32)
    inorder = np.where(batch.prev < s, 0.0, -np.inf)
    pred[:, :, :p] = batch.pred
    pred[:, :, p] = batch.prev
    lat[:, :, :p] = batch.pred_lat
    lat[:, :, p] = inorder
    volbw[:, :, :p] = batch.pred_volbw
    volbw[:, :, p] = inorder
    cached = (pred, lat, volbw)
    object.__setattr__(batch, "_pop_gather_inputs", cached)
    return cached


def _relax_pop(batch: ScenarioBatch, duration: np.ndarray, backend: str,
               device: torch.device) -> np.ndarray:
    """Upload the gather inputs once and run ``batch.depth`` sweeps: the
    kernel (``"cuda"``) or its plain version (``"torch"``)."""
    pred, lat, volbw = _pop_gather_inputs(batch)
    args = [torch.from_numpy(x).to(device) for x in
            (pred, lat, volbw, duration.astype(np.float32),
             batch.release.astype(np.float32))]
    relax = ops.sim_relax_pop if backend == "cuda" else sim_relax_pop_torch
    end = relax(*args, n_steps=batch.depth)
    return end.cpu().numpy().astype(np.float64)


def simulate_suite(graphs: list[AppGraph], machines, schedules, *,
                   jitter: float = 0.0, seeds=None,
                   releases: list[dict[int, float] | None] | None = None,
                   faults=None,
                   backend: str = "cuda",
                   device: str | torch.device = "cuda",
                   verify: bool = False) -> BatchSimResult:
    """Convenience wrapper: lower ``(graph, machine, schedule)`` triples
    and evaluate them in one batched call. ``machines`` may be a single
    machine (shared by every scenario) or one per graph; ``faults`` a
    single fault script (shared) or one per graph (``None`` entries =
    healthy). ``verify`` as in :func:`simulate_batch`."""
    check_backend(backend, device)
    if isinstance(machines, MachineModel):
        machines = [machines] * len(graphs)
    rel = releases if releases is not None else [None] * len(graphs)
    if faults is None or not isinstance(faults, (list, tuple)):
        faults = [faults] * len(graphs)
    if not (len(graphs) == len(machines) == len(schedules) == len(rel)
            == len(faults)):
        raise ValueError(
            f"scenario parts disagree: {len(graphs)} graphs, "
            f"{len(machines)} machines, {len(schedules)} schedules, "
            f"{len(rel)} release maps, {len(faults)} fault scripts")
    scenarios = [lower_scenario(g, m, s, releases=r, faults=f)
                 for g, m, s, r, f in zip(graphs, machines, schedules,
                                          rel, faults)]
    return simulate_batch(scenarios, jitter=jitter, seeds=seeds,
                          backend=backend, device=device, verify=verify)
