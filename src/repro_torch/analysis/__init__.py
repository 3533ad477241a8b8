# Static analysis: prove every placement the system emits.
#
# Two layers, one goal — turn the repo's implicit contracts into named,
# checkable invariants:
#   verify   — Schedule/Timeline/SimResult/ScenarioBatch/ClusterState
#              invariants (overlap, precedence+comm, release floors,
#              namespaces, transaction journals); rides behind the
#              `verify=` flag of the registry, simulate_batch/suite,
#              OnlineAMTHA and RecoveryParams.
#              `python -m repro_torch.analysis.verify --quick` is the sweep.
#   ir_lint  — lowered-array contracts (shapes, CSR, waves, padding
#              sentinels, gather bounds) checked before kernel launch.
from .ir_lint import (IRLintError, check_gather_bounds, check_shape,
                      lint_batch, lint_graph_arrays, lint_ir,
                      lint_machine_arrays, lint_population_arrays,
                      lint_scenario_arrays)
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
]
