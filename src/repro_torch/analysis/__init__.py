# Static analysis: prove every placement the system emits.
#
# Four layers, one goal — turn the repo's implicit contracts into named,
# checkable invariants:
#   verify   — Schedule/Timeline/SimResult/ScenarioBatch/ClusterState
#              invariants (overlap, precedence+comm, release floors,
#              namespaces, transaction journals); rides behind the
#              `verify=` flag of the registry, simulate_batch/suite,
#              OnlineAMTHA and RecoveryParams.
#              `python -m repro_torch.analysis.verify --quick` is the sweep.
#   ir_lint  — lowered-array contracts (shapes, CSR, waves, padding
#              sentinels, gather bounds) checked before kernel launch.
#   lint     — AST rules for the source itself (host syncs and float64 in
#              the torch device scope, frozen-dataclass mutation,
#              deprecated APIs); `python -m repro_torch.analysis.lint`.
#   tracecheck — aten-op analysis of every hot entry point in the
#              entrypoints manifest (retraces from host branches on data,
#              host read-backs, baked uploads, float64 and widening casts,
#              FLOPs against a cost model); `python -m
#              repro_torch.analysis.tracecheck --quick [--device cpu]`.
# `KINDS` here is the verifier's, as in the reference; the tracecheck's
# are `tracecheck.KINDS`.
from .entrypoints import (MANIFEST, SUITES, Built, CostRef, EntryPoint,
                          manifest, register_entrypoint)
from .ir_lint import (IRLintError, check_gather_bounds, check_shape,
                      lint_batch, lint_graph_arrays, lint_ir,
                      lint_machine_arrays, lint_population_arrays,
                      lint_scenario_arrays)
from .lint import LintViolation, lint_file, lint_paths, lint_source
from .tracecheck import (EntryReport, assert_clean, run_tracecheck,
                         trace_entry)
from .verify import (KINDS, VerifyError, Violation, verified_scheduler,
                     verified_simulator, verify_batch_result,
                     verify_cluster, verify_schedule, verify_sim_result,
                     verify_timeline)

__all__ = [
    "KINDS", "Violation", "VerifyError",
    "verify_schedule", "verify_timeline", "verify_sim_result",
    "verify_batch_result", "verify_cluster",
    "verified_scheduler", "verified_simulator",
    "IRLintError", "check_gather_bounds", "check_shape", "lint_ir",
    "lint_machine_arrays", "lint_graph_arrays", "lint_scenario_arrays",
    "lint_batch", "lint_population_arrays",
    "LintViolation", "lint_source", "lint_file", "lint_paths",
    "Built", "CostRef", "EntryPoint", "MANIFEST", "SUITES", "manifest",
    "register_entrypoint",
    "EntryReport", "assert_clean", "run_tracecheck", "trace_entry",
]
