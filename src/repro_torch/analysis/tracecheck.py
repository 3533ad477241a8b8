"""Trace-level analysis of every hot entry point of the port.

``analysis.verify`` proves the *schedules* the port emits;
``analysis.lint`` reads the *source*. This module checks what a call
really runs: for every entry point in
:mod:`repro_torch.analysis.entrypoints` it calls the entry once on a
device under a recorder of the aten ops the call dispatches, then runs
five passes over the record.

The recorder is :class:`repro_torch.launch.op_analysis.Recorder`, a
``torch.utils._python_dispatch.TorchDispatchMode`` shared with the
dry-run's cost analysis: it sees every aten op after PyTorch's composite
decompositions (so ``.item()``, ``float()`` and ``.tolist()`` all arrive
as ``aten._local_scalar_dense``, ``.float()`` and ``.to()`` as
``aten._to_copy``) with its real tensors, their shapes, dtypes and
devices, on the CPU and on the card alike. ``torch.fx`` tracing would
not do: it stops at data-dependent host branches, which are exactly
what pass 1 looks for. FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``, itself such a mode, and
bytes from the recorder's traffic proxy
(:func:`repro_torch.launch.op_analysis.call_cost`). The CUDA kernels of
``kernels/csrc`` launch through ``ctypes`` and are invisible to any
dispatch mode; on the card a report therefore also records the delta of
every ``ops.*.launches`` count over the call, so it shows that the
kernel ran. An *abstract* entry (``Built.abstract``: the model-stack
cost entries) is built and called on fake CPU tensors whatever the
device, so on the card it launches nothing and its report says so.

1. **retrace** — call the entry across its canned sweep of
   same-shape/different-value arguments and compare each call's
   sequence of (op, shapes, dtypes, devices) with the first call's. A
   different sequence means the host branches on values: the eager
   counterpart of jit keying on values, and what stops a CUDA graph from
   capturing the call. The count is the number of distinct sequences
   less one.
2. **host-sync** — ``aten._local_scalar_dense`` (a scalar read back to
   the host), a copy from the card to the host, and card ops whose
   output size depends on the data (``nonzero``, ``masked_select``,
   ``unique``, boolean-mask indexing): each waits for the card. A
   finding when a call makes more of them than its entry's
   ``host_syncs`` declares. On the CPU no copy leaves a device, so only
   the scalar reads count there.
3. **baked-const** — host data of at least the entry's
   ``const_bytes_limit`` put on the card (a host-to-device copy) or
   wrapped as a tensor (``aten.lift_fresh``) inside one call: the
   "closed over the population" bug, one upload per call that an
   argument would make once.
4. **dtype** — a float64 or complex128 value in any op unless the entry
   has ``allow_f64``; a floating array widened (``aten._to_copy``,
   ``copy_`` into a wider tensor, or an op that promotes a floating
   input to a wider output) unless it has ``allow_upcast``.
5. **cost-model** — matmul FLOPs counted by ``FlopCounterMode`` and
   the traffic proxy's bytes (operand plus result bytes of every op but
   views, metadata and allocations), each cross-checked against the
   entry's :class:`CostRef` within its ratio bounds (``flops_bounds``,
   ``bytes_bounds``), where it has one, as the reference checks its
   HLO's dot FLOPs and traffic. Eager code runs unfused, so its traffic
   runs above a compiled program's.

Findings are :class:`repro_torch.analysis.verify.Violation` values with
this module's own ``KINDS``; :func:`assert_clean` raises
:class:`~repro_torch.analysis.verify.VerifyError`.
``python -m repro_torch.analysis.tracecheck --quick [--device cuda|cpu]``
(first suite of every manifest entry) prints one JSON line per entry and
exits 1 on any finding. It writes no file.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..launch.op_analysis import OpRecord, Recorder, _nbytes, call_cost
from ..launch.op_analysis import record as record_call
from .entrypoints import Built, CostRef, EntryPoint, manifest
from .verify import VerifyError, Violation

__all__ = ["KINDS", "EntryReport", "OpRecord", "Recorder", "assert_clean",
           "check_baked_consts", "check_costs", "check_dtypes",
           "check_host_sync", "check_retrace", "main", "run_tracecheck",
           "trace_entry"]

#: the closed set of violation kinds this analyzer emits
KINDS = ("retrace", "host-sync", "baked-const", "dtype", "cost-model")

#: card ops whose output size depends on the data (a read-back inside)
_DATA_SIZED = frozenset({"nonzero", "masked_select", "_unique", "_unique2",
                         "unique_dim", "unique_consecutive",
                         "unique_dim_consecutive", "repeat_interleave"})

_WIDE = (torch.float64, torch.complex128)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record(built: Built, device: torch.device
           ) -> tuple[list[OpRecord], float]:
    """The ops and the matmul FLOPs of one call of ``built.fn``."""
    with torch.no_grad():
        ops, flops, _ = record_call(built.fn, *built.args,
                                    answer_reads=built.abstract)
        _sync(device)
    return ops, flops


# ---------------------------------------------------------------------------
# pass 1: retrace detector
# ---------------------------------------------------------------------------

def check_retrace(built: Built, first: list[OpRecord], entry: str,
                  device: torch.device
                  ) -> tuple[Optional[int], list[Violation]]:
    """Call the entry across its sweep and count the distinct op
    sequences beyond the first call's. Returns ``(n_retraces,
    violations)`` — ``None`` when the entry has no sweep."""
    if not built.sweep:
        return None, []
    seqs = {tuple(first)}
    for alt in built.sweep:
        with torch.no_grad(), Recorder() as rec:
            built.fn(*alt)
            _sync(device)
        seqs.add(tuple(rec.ops))
    retraces = len(seqs) - 1
    if not retraces:
        return 0, []
    return retraces, [Violation(
        "retrace",
        f"{entry}: {retraces} different op sequence(s) across "
        f"{len(built.sweep) + 1} same-shape call(s) — the host branches "
        f"on argument values, so no CUDA graph can capture the call")]


# ---------------------------------------------------------------------------
# pass 2: host-sync detector
# ---------------------------------------------------------------------------

def host_syncs(ops: list[OpRecord]) -> list[str]:
    """Each host read-back of one call, as ``op`` names in call order."""
    out = []
    for r in ops:
        devs = {m[2] for m in r.inputs}
        if r.op == "_local_scalar_dense":
            out.append(r.op)
        elif r.op in ("_to_copy", "copy_") and r.outputs \
                and r.inputs:
            src = r.inputs[1][2] if r.op == "copy_" else r.inputs[0][2]
            dst = r.outputs[0][2]
            if src == "cuda" and dst == "cpu":
                out.append(f"{r.op}(cuda->cpu)")
        elif "cuda" in devs and (r.op in _DATA_SIZED or (
                r.op == "index" and any(m[1] == torch.bool
                                        for m in r.inputs[1:]))):
            out.append(r.op)
    return out


def check_host_sync(ops: list[OpRecord], entry: str,
                    allowed: int = 0) -> list[Violation]:
    syncs = host_syncs(ops)
    if len(syncs) <= allowed:
        return []
    return [Violation(
        "host-sync",
        f"{entry}: {len(syncs)} host read-back(s) per call "
        f"({', '.join(syncs[:8])}{', ...' if len(syncs) > 8 else ''}), "
        f"{allowed} declared — each waits for the card")]


# ---------------------------------------------------------------------------
# pass 3: baked-constant detector
# ---------------------------------------------------------------------------

def check_baked_consts(ops: list[OpRecord], entry: str,
                       limit: int = 64 * 1024) -> list[Violation]:
    out = []
    for r in ops:
        what = None
        if r.op in ("lift_fresh", "lift_fresh_copy") and r.outputs:
            what, src = "tensor made from host data", r.outputs[0]
        elif r.op in ("_to_copy", "copy_") and r.inputs and r.outputs:
            src = r.inputs[1] if r.op == "copy_" else r.inputs[0]
            if src[2] == "cpu" and r.outputs[0][2] == "cuda":
                what = "host-to-device upload"
        if what is None:
            continue
        nbytes = _nbytes(src)
        if nbytes >= limit:
            out.append(Violation(
                "baked-const",
                f"{entry}: {what} of {nbytes} B {src[0]} {src[1]} inside "
                f"one call (limit {limit} B) — pass it as an argument on "
                f"the device so it is made once"))
    return out


# ---------------------------------------------------------------------------
# pass 4: dtype drift
# ---------------------------------------------------------------------------

def _widened(src, dtype: torch.dtype) -> bool:
    shape, sdt, _ = src
    return (sdt.is_floating_point and dtype.is_floating_point
            and len(shape) >= 1 and dtype.itemsize > sdt.itemsize)


def check_dtypes(ops: list[OpRecord], entry: str, *, allow_f64: bool = False,
                 allow_upcast: bool = False) -> list[Violation]:
    out, seen = [], set()
    for r in ops:
        if not allow_f64:
            for _, dt, _ in r.inputs + r.outputs:
                if dt in _WIDE and ("f64", r.op) not in seen:
                    seen.add(("f64", r.op))
                    out.append(Violation(
                        "dtype",
                        f"{entry}: {str(dt).removeprefix('torch.')} value "
                        f"in `{r.op}` — accidental float64 in a "
                        f"float32/bf16 path"))
        if allow_upcast or not r.outputs:
            continue
        dst = r.outputs[0][1]
        for src in (r.inputs[1:2] if r.op == "copy_" else r.inputs):
            if _widened(src, dst) and ("up", r.op) not in seen:
                seen.add(("up", r.op))
                out.append(Violation(
                    "dtype",
                    f"{entry}: float array {src[0]} widened {src[1]} -> "
                    f"{dst} by `{r.op}` — a stray cast or a promotion in "
                    f"the hot path"))
    return out


# ---------------------------------------------------------------------------
# pass 5: cost cross-check
# ---------------------------------------------------------------------------

def check_costs(flops: float, traffic: Optional[float],
                ref: Optional[CostRef], entry: str
                ) -> tuple[Optional[dict], list[Violation]]:
    """Ratio the counted FLOPs and traffic bytes against the roofline
    reference. Returns ``(cost_row, violations)``."""
    if ref is None:
        return None, []
    out = []
    fr = flops / ref.flops if ref.flops else float("inf")
    br = (traffic / ref.hbm_bytes
          if traffic is not None and ref.hbm_bytes else None)
    row = {"model_flops": ref.flops, "counted_flops": flops,
           "flops_ratio": fr, "flops_bounds": list(ref.flops_bounds),
           "model_bytes": ref.hbm_bytes, "counted_bytes": traffic,
           "bytes_ratio": br, "bytes_bounds": list(ref.bytes_bounds),
           "source": ref.source}
    lo, hi = ref.flops_bounds
    if not lo <= fr <= hi:
        out.append(Violation(
            "cost-model",
            f"{entry}: counted matmul FLOPs {flops:.3e} vs roofline "
            f"{ref.flops:.3e} — ratio {fr:.3f} outside [{lo}, {hi}]; the "
            f"cost model has drifted from the program"))
    if br is not None:
        blo, bhi = ref.bytes_bounds
        if not blo <= br <= bhi:
            out.append(Violation(
                "cost-model",
                f"{entry}: counted traffic {traffic:.3e} B vs roofline "
                f"{ref.hbm_bytes:.3e} B — ratio {br:.3f} outside "
                f"[{blo}, {bhi}]"))
    return row, out


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _launch_counts() -> dict[str, int]:
    """Every ``kernels.ops`` wrapper's launch count."""
    from ..kernels import ops
    return {n: f.launches for n, f in vars(ops).items()
            if isinstance(getattr(f, "launches", None), int)}


@dataclass
class EntryReport:
    """Everything one (entry, suite) pass produced."""

    entry: str
    suite: str
    device: str
    violations: tuple[Violation, ...] = ()
    retraces: Optional[int] = None            # None = pass skipped
    n_ops: int = 0
    host_syncs: tuple[str, ...] = ()
    launches: dict[str, int] = field(default_factory=dict)
    flops: float = 0.0
    traffic: float = 0.0
    cost: Optional[dict] = None
    abstract: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations

    def row(self) -> dict[str, Any]:
        return {"entry": self.entry, "suite": self.suite,
                "device": self.device, "ok": self.ok,
                "violations": [str(v) for v in self.violations],
                "retraces": self.retraces, "n_ops": self.n_ops,
                "host_syncs": list(self.host_syncs),
                "launches": self.launches, "flops": self.flops,
                "traffic_bytes": self.traffic, "cost": self.cost,
                "abstract": self.abstract}


def trace_entry(ep: EntryPoint, suite: str,
                device: str | torch.device = "cuda") -> EntryReport:
    """Build one (entry, suite) instantiation on ``device`` (an abstract
    entry on fake CPU tensors whatever the device) and run all five
    passes."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tracecheck on cuda needs a CUDA device "
                           "(pass device='cpu' for the CPU)")
    built = ep.build(suite, device)
    try:
        before = _launch_counts()
        ops, flops = record(built, device)
        launches = {k: n - before[k] for k, n in _launch_counts().items()
                    if n != before[k]}
        violations: list[Violation] = []
        retraces, v = check_retrace(built, ops, ep.name, device)
        violations += v
    finally:
        if built.stack is not None:
            built.stack.close()
    traffic = call_cost(ops, flops).traffic_bytes
    violations += check_host_sync(ops, ep.name, ep.host_syncs)
    violations += check_baked_consts(ops, ep.name,
                                     limit=ep.const_bytes_limit)
    violations += check_dtypes(ops, ep.name, allow_f64=ep.allow_f64,
                               allow_upcast=ep.allow_upcast)
    cost, v = check_costs(flops, traffic, built.cost_ref, ep.name)
    violations += v
    return EntryReport(ep.name, suite, str(device), tuple(violations),
                       retraces, len(ops), tuple(host_syncs(ops)),
                       launches, flops, traffic, cost, built.abstract)


def assert_clean(reports: list[EntryReport]) -> list[EntryReport]:
    """Raise :class:`VerifyError` carrying every violation of a sweep
    (the programmatic form of the CLI's exit code)."""
    violations = [v for r in reports for v in r.violations]
    if violations:
        raise VerifyError(violations)
    return reports


def run_tracecheck(*, quick: bool = False, entries=None,
                   device: str | torch.device = "cuda"
                   ) -> list[EntryReport]:
    """Sweep the manifest: every entry point, every suite (``quick``
    restricts to each entry's first suite). ``entries`` filters by
    substring match on the entry name."""
    reports = []
    for ep in manifest():
        if entries and not any(pat in ep.name for pat in entries):
            continue
        suites = ep.suites[:1] if quick else ep.suites
        for suite in suites:
            reports.append(trace_entry(ep, suite, device))
    return reports


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="aten-op trace analysis of every registered entry "
                    "point of the port (retrace, host-sync, baked-const, "
                    "dtype, cost cross-check)")
    ap.add_argument("--quick", action="store_true",
                    help="first suite of each entry only")
    ap.add_argument("--entries", nargs="*", default=None,
                    help="substring filter on entry names")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entries run (default: the card)")
    args = ap.parse_args(argv)
    reports = run_tracecheck(quick=args.quick, entries=args.entries,
                             device=args.device)
    for r in reports:
        print(json.dumps(r.row()))
    bad = sum(len(r.violations) for r in reports)
    print(f"{len(reports)} entry/suite pass(es), {bad} violation(s)",
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
