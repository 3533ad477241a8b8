"""IR linter: prove the lowered array contracts before kernels launch.

``core.lowering`` documents per-field contracts (shape/dtype comments on
every dataclass) that the NumPy relaxers and the CUDA kernels *assume* —
a CSR pointer that is not monotone, a wave index that is not
topological, or a gather index past the sentinel slot does not fail
cleanly on the card, it reads the wrong memory and returns a plausible
wrong schedule score. This module turns each assumption into a named
check:

* :func:`lint_machine_arrays` / :func:`lint_graph_arrays` /
  :func:`lint_scenario_arrays` / :func:`lint_batch` /
  :func:`lint_population_arrays` — one per lowered container, each
  validating shapes, dtypes, CSR well-formedness, topological wave
  indices, padding-sentinel consistency and index ranges;
* :func:`lint_ir` — type-dispatched convenience over all of the above;
* :func:`check_gather_bounds` / :func:`check_shape` — the helpers the
  checks share. Every value is checked: the port runs eagerly, so there
  is no abstract operand to exempt (the kernel entry points in
  ``kernels.ops`` run their own bound checks on tensors).

All violations raise :class:`IRLintError` with the offending field
named. Checks are pure reads — nothing is mutated, nothing is lowered.
"""

from __future__ import annotations

import numpy as np

from ..core import lowering

__all__ = ["IRLintError", "check_gather_bounds", "check_shape",
           "lint_batch", "lint_graph_arrays", "lint_ir",
           "lint_machine_arrays", "lint_population_arrays",
           "lint_scenario_arrays"]


class IRLintError(ValueError):
    """A lowered-array contract violation, named after its field."""


def _fail(name: str, why: str):
    raise IRLintError(f"{name}: {why}")


def check_shape(name: str, arr, shape: tuple) -> None:
    """Shape check over anything with a ``.shape`` (plain sequences are
    accepted too)."""
    got = tuple(arr.shape) if hasattr(arr, "shape") else np.shape(arr)
    if got != tuple(shape):
        _fail(name, f"shape {got} != expected {tuple(shape)}")


def check_gather_bounds(idx, hi: int, name: str) -> None:
    """Every index in ``[0, hi]`` (``hi`` itself is the padding
    sentinel slot). An out-of-bounds gather is exactly the device
    failure mode this module exists to catch: the kernel reads the wrong
    subtask's end (or stray memory), and the score comes back plausible
    but wrong."""
    a = np.asarray(idx)
    if a.size == 0:
        return
    lo, top = int(a.min()), int(a.max())
    if lo < 0 or top > hi:
        _fail(name, f"gather-bounds: indices span [{lo}, {top}], "
                    f"outside [0, {hi}]")


def _check_csr(name: str, ptr: np.ndarray, idx: np.ndarray, n_rows: int,
               n_targets: int) -> None:
    check_shape(f"{name}_ptr", ptr, (n_rows + 1,))
    if ptr[0] != 0:
        _fail(f"{name}_ptr", f"ptr[0] = {ptr[0]} != 0")
    if np.any(np.diff(ptr) < 0):
        _fail(f"{name}_ptr", "row pointers not monotone")
    if ptr[-1] != len(idx):
        _fail(f"{name}_ptr", f"ptr[-1] = {ptr[-1]} != {len(idx)} entries")
    if len(idx) and (idx.min() < 0 or idx.max() >= n_targets):
        _fail(f"{name}_sid", f"targets span [{idx.min()}, {idx.max()}], "
                             f"outside [0, {n_targets})")


def _check_int(name: str, arr: np.ndarray) -> None:
    if not np.issubdtype(np.asarray(arr).dtype, np.integer):
        _fail(name, f"dtype {np.asarray(arr).dtype} is not integral")


def lint_machine_arrays(ma: lowering.MachineArrays) -> None:
    c, n_inst = ma.n_cores, len(ma.inst_level)
    _check_int("core_types", ma.core_types)
    check_shape("core_types", ma.core_types, (c,))
    if c and (ma.core_types.min() < 0 or ma.core_types.max() >= ma.n_types):
        _fail("core_types", f"type ids outside [0, {ma.n_types})")
    for name, arr in (("lat", ma.lat), ("bw", ma.bw),
                      ("pair_instance", ma.pair_instance)):
        check_shape(name, arr, (c, c))
    if np.any(np.diag(ma.lat) != 0.0):
        _fail("lat", "nonzero diagonal (same-core latency must be 0)")
    if np.any(~np.isfinite(ma.lat)) or np.any(ma.lat < 0):
        _fail("lat", "latencies must be finite and >= 0")
    if np.any(np.diag(ma.bw) != np.inf):
        _fail("bw", "diagonal must be inf (same-core vol/bw = 0)")
    if np.any(ma.bw <= 0):
        _fail("bw", "bandwidths must be positive")
    _check_int("pair_instance", ma.pair_instance)
    if np.any(np.diag(ma.pair_instance) != -1):
        _fail("pair_instance", "diagonal must be -1 (no shared level)")
    off = ma.pair_instance[~np.eye(c, dtype=bool)]
    if off.size and (off.min() < 0 or off.max() >= n_inst):
        _fail("pair_instance", f"instance ids outside [0, {n_inst})")
    check_shape("inst_lat", ma.inst_lat, (n_inst,))
    check_shape("inst_bw", ma.inst_bw, (n_inst,))
    if np.any(ma.inst_bw <= 0):
        _fail("inst_bw", "instance bandwidths must be positive")


def lint_graph_arrays(ga: lowering.GraphArrays) -> None:
    s = ga.n_subtasks
    check_shape("exec_type", ga.exec_type, (s, ga.n_types))
    if np.any(~np.isfinite(ga.exec_type)) or np.any(ga.exec_type < 0):
        _fail("exec_type", "exec times must be finite and >= 0")
    _check_int("task_of", ga.task_of)
    check_shape("task_of", ga.task_of, (s,))
    if s and (ga.task_of.min() < 0 or ga.task_of.max() >= ga.n_tasks):
        _fail("task_of", f"task ids outside [0, {ga.n_tasks})")
    _check_csr("pred", ga.pred_ptr, ga.pred_sid, s, s)
    _check_csr("succ", ga.succ_ptr, ga.succ_sid, s, s)
    if len(ga.pred_sid) != len(ga.succ_sid):
        _fail("pred_sid", f"{len(ga.pred_sid)} pred edges vs "
                          f"{len(ga.succ_sid)} succ edges")
    check_shape("pred_vol", ga.pred_vol, (len(ga.pred_sid),))
    check_shape("succ_vol", ga.succ_vol, (len(ga.succ_sid),))
    if np.any(ga.pred_vol < 0) or np.any(ga.succ_vol < 0):
        _fail("pred_vol", "edge volumes must be >= 0")
    # Kahn over the pred CSR: every relaxation order assumes a DAG
    indeg = np.diff(ga.pred_ptr).astype(np.int64).copy()
    stack = list(np.flatnonzero(indeg == 0))
    sp, ss = ga.succ_ptr, ga.succ_sid
    seen = 0
    while stack:
        v = int(stack.pop())
        seen += 1
        for t in ss[sp[v]:sp[v + 1]]:
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(int(t))
    if seen != s:
        _fail("pred_ptr", f"dependency graph has a cycle "
                          f"({s - seen} subtasks unreachable)")


def lint_scenario_arrays(sa: lowering.ScenarioArrays) -> None:
    lint_graph_arrays(sa.graph)
    lint_machine_arrays(sa.machine)
    s, c = sa.graph.n_subtasks, sa.machine.n_cores
    check_shape("exec_core", sa.exec_core, (s, c))
    _check_int("core_of", sa.core_of)
    check_shape("core_of", sa.core_of, (s,))
    if s and (sa.core_of.min() < 0 or sa.core_of.max() >= c):
        _fail("core_of", f"cores outside [0, {c})")
    for name, arr in (("start", sa.start), ("end", sa.end),
                      ("release", sa.release)):
        check_shape(name, arr, (s,))
    if np.any(~np.isfinite(sa.start)) or np.any(~np.isfinite(sa.end)):
        _fail("start", "scheduled intervals must be finite")
    if np.any(sa.end < sa.start):
        _fail("end", "interval ends before it starts")
    _check_int("order_sid", sa.order_sid)
    _check_csr("order", sa.order_ptr, sa.order_sid, c, max(s, 1))
    if sorted(sa.order_sid.tolist()) != list(range(s)):
        _fail("order_sid", "not a permutation of the subtasks")
    for core in range(c):
        sids = sa.order_sid[sa.order_ptr[core]:sa.order_ptr[core + 1]]
        if np.any(sa.core_of[sids] != core):
            _fail("order_sid", f"core {core}'s order lists foreign sids")
        if np.any(np.diff(sa.start[sids]) < 0):
            _fail("order_sid", f"core {core}'s order not sorted by start")
    if sa.fault is not None:
        check_shape("fault.fail_t", sa.fault.fail_t, (c,))


def lint_batch(batch: lowering.ScenarioBatch) -> None:
    """The pre-launch check for ``sim_step`` / ``sim_relax`` /
    ``sim_relax_pop`` / ``relax_batch_np``: shapes, sentinel/padding consistency, gather
    bounds and topological wave indices — everything the relaxation
    sweep gathers blindly."""
    b, s, p = batch.n_scenarios, batch.max_subtasks, batch.max_preds
    _check_int("n_sub", batch.n_sub)
    check_shape("n_sub", batch.n_sub, (b,))
    if b and (batch.n_sub.min() < 0 or batch.n_sub.max() > s):
        _fail("n_sub", f"subtask counts outside [0, {s}]")
    for name, arr in (("duration", batch.duration),
                      ("release", batch.release), ("wave", batch.wave)):
        check_shape(name, arr, (b, s))
    for name, arr in (("pred", batch.pred), ("pred_lat", batch.pred_lat),
                      ("pred_volbw", batch.pred_volbw)):
        check_shape(name, arr, (b, s, p))
    check_shape("prev", batch.prev, (b, s))
    check_shape("t_est", batch.t_est, (b,))
    _check_int("prev", batch.prev)
    _check_int("pred", batch.pred)
    check_gather_bounds(batch.prev, s, "prev")
    check_gather_bounds(batch.pred, s, "pred")
    if np.any(batch.duration < 0) or np.any(~np.isfinite(batch.duration)):
        _fail("duration", "durations must be finite and >= 0")
    valid = batch.valid
    # sentinel consistency: a padded pred slot is exactly (S, -inf, -inf)
    pad = batch.pred == s
    if np.any(pad != np.isneginf(batch.pred_lat)) \
            or np.any(pad != np.isneginf(batch.pred_volbw)):
        _fail("pred_lat", "padding sentinel (pred == S) and -inf lag "
                          "pads disagree")
    real = ~pad
    if np.any(batch.pred_lat[real] < 0) or np.any(batch.pred_volbw[real] < 0):
        _fail("pred_lat", "real-edge lags must be >= 0")
    # padded rows must be inert: no work, no edges
    inv = ~valid
    if np.any(batch.duration[inv] != 0) or np.any(batch.prev[inv] != s) \
            or np.any(batch.pred[inv] != s):
        _fail("n_sub", "padded subtask rows carry work or edges")
    # topological waves: every gathered producer sits on a strictly
    # earlier wave, and depth covers the deepest chain
    if b and s:
        wave = batch.wave
        buf = np.concatenate([wave, np.full((b, 1), -1, wave.dtype)], axis=1)
        flat = buf.reshape(-1)
        row = np.arange(b) * (s + 1)
        pw = flat[batch.prev + row[:, None]]
        bad = valid & (batch.prev < s) & (pw >= wave)
        if np.any(bad):
            _fail("wave", "in-order edge does not increase the wave index")
        pw = flat[batch.pred + row[:, None, None]]
        bad = valid[:, :, None] & real & (pw >= wave[:, :, None])
        if np.any(bad):
            _fail("wave", "dependency edge does not increase the wave "
                          "index")
        need = int(wave[valid].max(initial=-1)) + 1
        if batch.depth < need:
            _fail("depth", f"depth {batch.depth} < deepest wave chain "
                           f"{need} (fixpoint not reached)")
    if batch.has_faults:
        check_shape("fail_t", batch.fail_t, (b, s))
        k = batch.slow_t.shape[2] if batch.slow_t.ndim == 3 else -1
        check_shape("slow_t", batch.slow_t, (b, s, k))
        check_shape("slow_f", batch.slow_f, (b, s, k))
        k2 = batch.deg_t.shape[3] if batch.deg_t.ndim == 4 else -1
        check_shape("deg_t", batch.deg_t, (b, s, p, k2))
        check_shape("deg_f", batch.deg_f, (b, s, p, k2))
        if np.any(batch.slow_f <= 0) or np.any(batch.deg_f <= 0):
            _fail("slow_f", "fault factors must be positive")


def lint_population_arrays(pa: lowering.PopulationArrays) -> None:
    """The pre-launch check for the device GA's decode gathers
    (``search.device``) and the ``sim_relax_pop`` sweeps they feed: the
    topological permutation and the pred-position indices are what the
    device decode and kernel trust blindly."""
    s, c, p = pa.n_subtasks, pa.n_cores, pa.max_preds
    _check_int("topo_sid", pa.topo_sid)
    check_shape("topo_sid", pa.topo_sid, (s,))
    if sorted(pa.topo_sid.tolist()) != list(range(s)):
        _fail("topo_sid", "not a permutation of the subtasks")
    _check_int("gene", pa.gene)
    check_shape("gene", pa.gene, (s,))
    if s and (pa.gene.min() < 0 or pa.gene.max() >= pa.n_tasks):
        _fail("gene", f"gene slots outside [0, {pa.n_tasks})")
    check_shape("exec_core", pa.exec_core, (s, c))
    if np.any(~np.isfinite(pa.exec_core)) or np.any(pa.exec_core < 0):
        _fail("exec_core", "exec times must be finite and >= 0")
    _check_int("pred_pos", pa.pred_pos)
    check_shape("pred_pos", pa.pred_pos, (s, p))
    check_gather_bounds(pa.pred_pos, s, "pred_pos")
    real = pa.pred_pos < s
    # topo order is the whole point: a producer must already be decoded
    if np.any(real & (pa.pred_pos >= np.arange(s)[:, None])):
        _fail("pred_pos", "producer at or after its consumer in topo "
                          "order")
    _check_int("pred_gene", pa.pred_gene)
    check_shape("pred_gene", pa.pred_gene, (s, p))
    if s and (pa.pred_gene.min() < 0 or pa.pred_gene.max() >= pa.n_tasks):
        _fail("pred_gene", f"pred gene slots outside [0, {pa.n_tasks})")
    check_shape("pred_vol", pa.pred_vol, (s, p))
    if np.any(pa.pred_vol < 0):
        _fail("pred_vol", "edge volumes must be >= 0")
    check_shape("lat", pa.lat, (c, c))
    check_shape("bw", pa.bw, (c, c))
    if np.any(pa.bw <= 0):
        _fail("bw", "bandwidths must be positive")


_DISPATCH = (
    (lowering.ScenarioBatch, lint_batch),
    (lowering.ScenarioArrays, lint_scenario_arrays),
    (lowering.PopulationArrays, lint_population_arrays),
    (lowering.GraphArrays, lint_graph_arrays),
    (lowering.MachineArrays, lint_machine_arrays),
)


def lint_ir(obj) -> None:
    """Type-dispatched entry point over every lowered container."""
    for cls, fn in _DISPATCH:
        if isinstance(obj, cls):
            fn(obj)
            return
    raise IRLintError(f"no IR lint for {type(obj).__name__}")
