"""Service metrics for a multiprogrammed timeline.

``evaluate`` replays the admitted timeline through a registry-selected
discrete-event simulator (the ``"arrays"`` lowered event loop by
default — bit-for-bit the seed ``"events"`` path — with the
arrival-injection hook and memory contention on), then reports the
quantities a streaming service cares about:

* throughput — completed apps per second over the busy span;
* response time — per-app ``finish - arrival`` (queueing + service),
  mean and p99;
* deadline-miss rate — fraction of apps finishing after their SLA
  deadline;
* prediction error — the paper's Eq. (4) ``%Dif_rel`` between the
  scheduler's T_est and the simulated T_exec, both per app and for the
  whole timeline. The offline paper keeps this under 4-6%; contention
  between co-scheduled apps is exactly the error source §6 predicts
  grows with communication volume.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.registry import get_simulator
from .state import ClusterState


@dataclass
class AppOutcome:
    app_id: int
    t_arrival: float
    deadline: float
    t_est_finish: float
    t_exec_finish: float            # inf = stranded by a fault / shed
    criticality: int = 0
    shed: bool = False              # dropped by recovery, never ran

    @property
    def response(self) -> float:
        return self.t_exec_finish - self.t_arrival

    @property
    def missed(self) -> bool:
        return self.t_exec_finish > self.deadline + 1e-9

    @property
    def dif_rel(self) -> float:
        """Eq. (4) analogue per app: overshoot relative to the app's own
        measured response. Normalising by a duration (not the absolute
        finish instant) keeps the metric time-translation invariant — a
        50% mispredict reads 50% whether the app arrived at t=100 or
        t=50000. A stranded/shed app has no measured response: 0."""
        if not np.isfinite(self.t_exec_finish):
            return 0.0
        return (self.t_exec_finish - self.t_est_finish) \
            / max(self.response, 1e-12) * 100.0


@dataclass
class OnlineMetrics:
    n_apps: int
    span: float                     # first arrival -> last simulated finish
    throughput: float               # apps / second
    mean_response: float
    p50_response: float
    p99_response: float
    deadline_miss_rate: float
    mean_dif_rel: float             # mean per-app Eq. (4) error, %
    makespan_dif_rel: float         # Eq. (4) on the whole timeline, %
    utilization: float
    # tiered SLO report (criticality -> value; response stats over apps
    # that finished, miss rate over all incl. stranded/shed)
    tier_p99: dict[int, float] = field(default_factory=dict)
    tier_miss_rate: dict[int, float] = field(default_factory=dict)
    n_shed: int = 0                 # dropped by recovery
    n_stranded: int = 0             # admitted but never finished (faults)
    outcomes: list[AppOutcome] = field(repr=False, default_factory=list)

    def row(self) -> dict:
        """JSON-friendly summary (no per-app detail); tier columns are
        flattened to ``p99_tier{k}`` / ``miss_tier{k}``."""
        out = {k: getattr(self, k) for k in (
            "n_apps", "span", "throughput", "mean_response", "p50_response",
            "p99_response", "deadline_miss_rate", "mean_dif_rel",
            "makespan_dif_rel", "utilization", "n_shed", "n_stranded")}
        for k in sorted(self.tier_p99):
            out[f"p99_tier{k}"] = self.tier_p99[k]
        for k in sorted(self.tier_miss_rate):
            out[f"miss_tier{k}"] = self.tier_miss_rate[k]
        return out


def evaluate(state: ClusterState, contention: bool = True,
             jitter: float = 0.0, seed: int = 0,
             simulator: str = "arrays", faults=None) -> OnlineMetrics:
    """Simulate the committed timeline and score it. ``simulator``
    selects the T_exec source by registry name (``"arrays"`` is the
    lowered event loop — bit-for-bit the seed ``"events"`` path).

    ``faults`` replays a fault script during the simulation: apps
    stranded by a dead core come back with ``inf`` finish (counted as
    misses, excluded from response stats). Apps the recovery shed
    (``state.shed``) are scored the same way. Per-criticality columns
    (``tier_p99`` / ``tier_miss_rate``) report the tiered SLO view."""
    if not state.apps and not state.shed:
        raise ValueError("no apps admitted")
    outcomes: list[AppOutcome] = []
    sim = None
    if state.apps:
        merged = state.merged_graph()
        kwargs = {"faults": faults} if faults is not None else {}
        sim = get_simulator(simulator)(
            merged, state.machine, state.schedule,
            contention=contention, jitter=jitter, seed=seed,
            releases=state.releases(), **kwargs)
        for a in state.apps:
            exec_fin = max(sim.subtask_end[s] for s in a.global_sids())
            outcomes.append(AppOutcome(
                app_id=a.app_id, t_arrival=a.arrival.t_arrival,
                deadline=a.arrival.deadline,
                t_est_finish=a.t_est_finish, t_exec_finish=exec_fin,
                criticality=a.arrival.criticality))
    inf = float("inf")
    for srec in state.shed:
        outcomes.append(AppOutcome(
            app_id=srec.app_id, t_arrival=srec.t_arrival,
            deadline=srec.deadline, t_est_finish=inf, t_exec_finish=inf,
            criticality=srec.criticality, shed=True))

    finished = [o for o in outcomes if np.isfinite(o.t_exec_finish)]
    n_shed = sum(o.shed for o in outcomes)
    n_stranded = len(outcomes) - len(finished) - n_shed
    first = min(o.t_arrival for o in outcomes)
    last = max((o.t_exec_finish for o in finished), default=first)
    span = max(last - first, 1e-12)
    responses = np.array([o.response for o in finished]) if finished \
        else np.zeros(1)
    t_est = state.schedule.makespan()
    tiers = sorted({o.criticality for o in outcomes})
    tier_p99, tier_miss = {}, {}
    for k in tiers:
        sub = [o for o in outcomes if o.criticality == k]
        fin = [o.response for o in sub if np.isfinite(o.t_exec_finish)]
        tier_p99[k] = float(np.percentile(fin, 99)) if fin else inf
        tier_miss[k] = float(sum(bool(o.missed) for o in sub) / len(sub))
    return OnlineMetrics(
        n_apps=len(outcomes),
        span=span,
        throughput=len(finished) / span,
        mean_response=float(responses.mean()),
        p50_response=float(np.percentile(responses, 50)),
        p99_response=float(np.percentile(responses, 99)),
        deadline_miss_rate=float(sum(bool(o.missed) for o in outcomes)
                                 / len(outcomes)),
        mean_dif_rel=float(np.mean([o.dif_rel for o in finished]))
        if finished else 0.0,
        makespan_dif_rel=(sim.t_exec - t_est) / max(sim.t_exec, 1e-12)
        * 100.0 if sim is not None else 0.0,
        utilization=state.utilization(horizon=last),
        tier_p99=tier_p99, tier_miss_rate=tier_miss,
        n_shed=n_shed, n_stranded=n_stranded,
        outcomes=outcomes,
    )
