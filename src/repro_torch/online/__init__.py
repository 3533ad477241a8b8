# Online multi-application scheduling: streaming AMTHA for clusters of
# multicores. Arrival processes (arrivals), the shared cluster timeline
# (state), warm-started incremental AMTHA (online_amtha), admission
# policies (policies), service metrics (metrics) and fault recovery
# (recovery: detection + transactional re-map + criticality shedding).
# The paper's offline algorithm is the degenerate case: one app arriving
# at t=0 onto an idle machine.
from .arrivals import (AppArrival, ArrivalParams, chain_lower_bound,
                       generate_workload)
from .metrics import AppOutcome, OnlineMetrics, evaluate
from .online_amtha import OnlineAMTHA, replay_fifo
from .policies import (BatchedPolicy, CriticalityPolicy, FIFOPolicy, Policy,
                       RankPriorityPolicy, app_rank, make_policy)
from .recovery import (Detection, RecoveryParams, RecoveryReport,
                       detect_progress, detect_script, recover,
                       recover_from_script)
from .state import AdmittedApp, ClusterState, ShedApp

__all__ = [
    "AppArrival", "ArrivalParams", "chain_lower_bound", "generate_workload",
    "ClusterState", "AdmittedApp", "ShedApp", "OnlineAMTHA", "replay_fifo",
    "Policy", "FIFOPolicy", "RankPriorityPolicy", "BatchedPolicy",
    "CriticalityPolicy", "app_rank", "make_policy",
    "OnlineMetrics", "AppOutcome", "evaluate",
    "Detection", "RecoveryParams", "RecoveryReport",
    "detect_script", "detect_progress", "recover", "recover_from_script",
]
