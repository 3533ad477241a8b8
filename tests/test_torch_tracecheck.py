"""The port's tracecheck on the CPU: a planted defect of each kind is
*named*, clean entries stay clean, the manifest is the reference's,
entry for entry (the model-stack cost entries abstract, on fake
tensors, their FLOPs and bytes both checked), and every guarded kernel
wrapper checks its inputs before it launches.

The defects are defined here (the reference's live in ``tests/defects``,
which is the reference's): each is a small callable that commits the one
fault its pass exists to catch."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.entrypoints as ref_entrypoints
import repro.analysis.tracecheck as ref_tracecheck
from repro_torch.analysis.entrypoints import (SUITES, Built, CostRef,
                                              EntryPoint, manifest,
                                              register_entrypoint)
from repro_torch.analysis.tracecheck import (KINDS, OpRecord,
                                             assert_clean, check_baked_consts,
                                             host_syncs, main,
                                             run_tracecheck, trace_entry)
from repro_torch.analysis.verify import VerifyError

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# planted defects, one per kind
# ---------------------------------------------------------------------------

def _retrace_build(suite, device):
    """The host loops ``scale`` times: the op sequence changes with the
    value, as a jit keyed on it would retrace."""
    x = torch.linspace(0.0, 1.0, 64, device=device)

    def scaled(x, scale):
        for _ in range(scale):
            x = x * 2.0
        return x.sum()

    return Built(fn=scaled, args=(x, 2), sweep=((x, 3), (x + 1.0, 4)))


def _hostsync_build(suite, device):
    """A norm that reads its total back to the host."""
    def leaky_norm(x):
        return x / (x.sum().item() + 1.0)

    x = torch.ones(32, device=device)
    return Built(fn=leaky_norm, args=(x,), sweep=((x * 2.0,),))


_POPULATION = np.ones((512, 512), np.float32)       # 1 MiB


def _baked_build(suite, device):
    """A 1 MiB host array turned into a tensor inside every call."""
    def score_against_baked(x):
        return (torch.tensor(_POPULATION, device=x.device) * x).sum(dim=1)

    return Built(fn=score_against_baked,
                 args=(torch.ones(512, device=device),))


def _dtype_build(suite, device):
    """bf16 math widened to float32 by a stray cast."""
    def widened(x):
        return (x.float() * 2.0).sum()

    return Built(fn=widened, args=(torch.ones((8, 8), dtype=torch.bfloat16,
                                              device=device),))


_M, _N, _K = 64, 96, 128


def _cost_build(suite, device):
    """A roofline reference that claims twice the matmul's FLOPs."""
    a = torch.ones((_M, _K), device=device)
    b = torch.ones((_K, _N), device=device)
    true_flops = 2.0 * _M * _N * _K
    ref = CostRef(flops=2.0 * true_flops,
                  hbm_bytes=4.0 * (_M * _K + _K * _N + _M * _N),
                  source="planted 2x-inflated reference")
    return Built(fn=lambda a, b: a @ b, args=(a, b), cost_ref=ref)


def _f64_build(suite, device):
    def f64(x):
        return (x.to(torch.float64) * 2.0).sum()

    return Built(fn=f64, args=(torch.ones(16, device=device),))


DEFECTS = {
    "retrace": EntryPoint("defect.retrace", _retrace_build),
    "host-sync": EntryPoint("defect.hostsync", _hostsync_build),
    "baked-const": EntryPoint("defect.baked", _baked_build),
    "dtype": EntryPoint("defect.dtype", _dtype_build),
    "cost-model": EntryPoint("defect.cost", _cost_build),
}


@pytest.mark.parametrize("kind", sorted(DEFECTS))
def test_defect_named(kind):
    report = trace_entry(DEFECTS[kind], "8core", CPU)
    assert not report.ok
    assert kind in {v.kind for v in report.violations}, \
        f"expected a {kind!r} finding, got {report.violations}"


def test_defect_kinds_closed_and_the_references():
    assert set(DEFECTS) == set(KINDS) == set(ref_tracecheck.KINDS)


def test_retrace_counts_distinct_sequences():
    report = trace_entry(DEFECTS["retrace"], "8core", CPU)
    assert report.retraces == 2          # one per swept value


def test_f64_found_without_a_flag():
    """float64 needs no x64 switch in PyTorch. (The reference's
    counterpart, ``test_f64_defect_under_x64``, fails on JAX 0.9.0, which
    has no ``jax.experimental.enable_x64``.)"""
    report = trace_entry(EntryPoint("defect.f64", _f64_build), "8core", CPU)
    assert "dtype" in {v.kind for v in report.violations}
    assert any("float64" in v.message for v in report.violations)
    allowed = EntryPoint("defect.f64-allowed", _f64_build, allow_f64=True,
                         allow_upcast=True)
    assert trace_entry(allowed, "8core", CPU).ok


def test_clean_entry_stays_clean_and_counts_the_references_flops():
    x, y = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    ep = EntryPoint(
        "test.clean",
        lambda suite, device: Built(
            fn=lambda x, y: (x @ y).sum(),
            args=(torch.from_numpy(x), torch.from_numpy(y)),
            sweep=((torch.zeros(8, 16), torch.from_numpy(y) * 3),)))
    report = trace_entry(ep, "8core", CPU)
    assert report.ok and report.retraces == 0
    closed = jax.make_jaxpr(lambda x, y: (x @ y).sum())(jnp.asarray(x),
                                                        jnp.asarray(y))
    assert report.flops == ref_tracecheck.jaxpr_dot_flops(closed) \
        == 2.0 * 8 * 16 * 4


def test_assert_clean_raises_verifyerror():
    with pytest.raises(VerifyError) as ei:
        assert_clean([trace_entry(DEFECTS["baked-const"], "8core", CPU)])
    assert "baked-const" in ei.value.kinds


def test_declared_host_syncs_are_no_finding():
    one = EntryPoint("test.one-sync", _hostsync_build, host_syncs=1)
    report = trace_entry(one, "8core", CPU)
    assert report.ok and report.host_syncs == ("_local_scalar_dense",)

    def twice(suite, device):
        x = torch.ones(4, device=device)
        return Built(fn=lambda x: x.sum().item() + x.max().item(),
                     args=(x,))

    report = trace_entry(EntryPoint("test.two-syncs", twice, host_syncs=1),
                         "8core", CPU)
    assert [v.kind for v in report.violations] == ["host-sync"]


def test_card_reads_and_uploads_are_recognised_from_the_record():
    """What only the card dispatches, held on records: a copy to the
    host, an op whose output size depends on the data, boolean-mask
    indexing and a large upload."""
    f32 = torch.float32
    recs = [
        OpRecord("_to_copy", (((8,), f32, "cuda"),), (((8,), f32, "cpu"),)),
        OpRecord("nonzero", (((8,), torch.bool, "cuda"),),
                 (((3, 1), torch.int64, "cuda"),)),
        OpRecord("index", (((8,), f32, "cuda"), ((8,), torch.bool, "cuda")),
                 (((3,), f32, "cuda"),)),
        OpRecord("nonzero", (((8,), torch.bool, "cpu"),),
                 (((3, 1), torch.int64, "cpu"),)),
        OpRecord("_to_copy", (((8,), f32, "cpu"),), (((8,), f32, "cuda"),)),
    ]
    assert host_syncs(recs) == ["_to_copy(cuda->cpu)", "nonzero", "index"]
    n = 64 * 1024 // 4
    upload = OpRecord("_to_copy", (((n,), f32, "cpu"),),
                      (((n,), f32, "cuda"),))
    assert check_baked_consts(recs, "x") == []
    assert [v.kind for v in check_baked_consts([upload], "x")] \
        == ["baked-const"]


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

#: the model-stack cost entries, built on fake tensors whatever the device
ABSTRACT = {"runtime.pipelined_forward", "autoplace.unit[gemma-2b]",
            "autoplace.unit[gemma2-2b]"}


def test_manifest_is_the_references_less_the_a13_entries():
    """The port's manifest is the reference's, entry for entry: names,
    suites and dtype flags (the unit entries ``allow_upcast``), and the
    units' FLOP bounds."""
    ref = [ep.name for ep in ref_entrypoints.MANIFEST]
    port = [ep.name for ep in manifest()]
    assert port == ref
    assert len(port) == len(set(port))
    for ep in manifest():
        assert ep.suites and all(s in SUITES for s in ep.suites), ep.name
        ref_ep = next(e for e in ref_entrypoints.MANIFEST
                      if e.name == ep.name)
        assert (ep.suites, ep.allow_upcast, ep.allow_f64) == \
            (ref_ep.suites, ref_ep.allow_upcast, ref_ep.allow_f64)
    from repro_torch.analysis.entrypoints import _UNIT_FLOP_BOUNDS
    assert _UNIT_FLOP_BOUNDS == ref_entrypoints._UNIT_FLOP_BOUNDS
    assert CostRef(1.0, 1.0).bytes_bounds == \
        ref_entrypoints.CostRef(1.0, 1.0).bytes_bounds


def test_register_entrypoint_rejects_duplicates():
    with pytest.raises(ValueError):
        register_entrypoint(manifest()[0])


def test_manifest_entries_clean_on_the_cpu():
    reports = run_tracecheck(device="cpu")
    assert {r.entry for r in reports} == {ep.name for ep in manifest()}
    assert_clean(reports)
    by = {r.entry: r for r in reports if r.suite == "8core"}
    assert by["online.admission_score"].host_syncs == ()   # nothing leaves
    assert by["sim.relax_pop"].host_syncs == ("_local_scalar_dense",) * 2
    assert all(r.launches == {} for r in reports)          # plain versions
    model = {r.entry: r for r in reports if r.suite == "model"}
    for name in ABSTRACT:
        r = model[name]
        assert r.abstract and r.row()["abstract"], name
        lo, hi = r.cost["flops_bounds"]
        blo, bhi = r.cost["bytes_bounds"]
        assert lo <= r.cost["flops_ratio"] <= hi, name
        assert blo <= r.cost["bytes_ratio"] <= bhi, name
        assert r.cost["counted_bytes"] == r.traffic > 0
    # rank 0 runs its stage for every microbatch, the bubble skipped
    assert model["runtime.pipelined_forward"].cost["flops_ratio"] == 1.0
    assert not model["kernels.flash_attention"].abstract
    assert not torch.distributed.is_initialized()   # the fake world is gone


def test_byte_term_names_a_drifted_traffic_reference():
    """A reference that claims 100x the bytes a matmul moves is a
    cost-model finding of its own, with the FLOPs right."""
    a, b = torch.ones((_M, _K)), torch.ones((_K, _N))
    moved = 4.0 * (_M * _K + _K * _N + _M * _N)
    for claim, ok in ((moved, True), (100.0 * moved, False)):
        ep = EntryPoint("test.bytes", lambda suite, device: Built(
            fn=lambda a, b: a @ b, args=(a, b),
            cost_ref=CostRef(flops=2.0 * _M * _N * _K, hbm_bytes=claim,
                             bytes_bounds=(0.5, 2.0))))
        report = trace_entry(ep, "8core", CPU)
        assert report.ok is ok
        assert report.cost["bytes_ratio"] == moved / claim
        if not ok:
            assert [v.kind for v in report.violations] == ["cost-model"]
            assert "traffic" in report.violations[0].message


def test_cli_quick_on_the_cpu_exits_zero(capsys):
    assert main(["--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(manifest())


# ---------------------------------------------------------------------------
# every kernel wrapper guards its launch
# ---------------------------------------------------------------------------

#: the full public op list of kernels/ops.py — a new wrapper must be
#: added here AND call check_shape/check_gather_bounds before launch
OPS = {"flash_attention", "rmsnorm", "ssd_scan", "sched_score",
       "sim_step", "sim_relax", "sim_relax_pop", "flash_decode",
       "flash_attention_bwd", "rmsnorm_bwd", "ssd_scan_bwd",
       "grad_sumsq", "adamw_update"}


def test_every_op_wrapper_checked():
    tree = ast.parse((SRC / "kernels" / "ops.py").read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
            if not n.name.startswith("_") and not n.name.startswith("check")}
    assert set(defs) == OPS, "ops.py public surface changed — update " \
                             "the pinned list and guard the new wrapper"
    helpers = {n.name: n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name.startswith("_")}

    def calls(fn, seen=()):
        out = set()
        for c in ast.walk(fn):
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Name):
                out.add(c.func.id)
                if c.func.id in helpers and c.func.id not in seen:
                    out |= calls(helpers[c.func.id], seen + (c.func.id,))
        return out

    for name, fn in defs.items():
        assert calls(fn) & {"check_shape", "check_gather_bounds"}, \
            f"ops.{name} launches without a shape guard"
