"""Streaming workloads: applications arriving over time.

The paper maps ONE application onto an idle machine. Its closing
direction — "clusters of multicores and hybrid programming paradigms"
(§7) — implies the multiprogramming regime: many independent MPAHA
applications arrive over time and compete for the same cores
(cf. Tousimojarad & Vanderbauwhede, arXiv:1403.8020). This module
layers arrival processes on the §5.1 synthetic generator:

* **poisson** — memoryless inter-arrival gaps at ``rate`` apps/second
  (model seconds, the same unit as subtask times);
* **bursty** — Poisson bursts of ``burst_size`` apps spread uniformly
  over ``burst_spread`` seconds, the heavy-tailed traffic shape that
  stresses admission policies far more than the same mean rate smoothed.

Each arrival carries an SLA deadline: ``t_arrival + slack * lower_bound``
where the lower bound is the app's longest task chain (no machine can
beat the critical chain, so ``slack`` is interpretable across machines)
and slack is drawn uniformly from ``sla_slack``. App sizes mix the
paper's two regimes: small (8-core-sized, 15-25 tasks) and large
(64-core-sized, 120-200 tasks) with probability ``p_large``.

Determinism: the whole workload is a pure function of ``seed``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..core.mpaha import AppGraph
from ..core.synth import SynthParams, generate_app


@dataclass(frozen=True)
class AppArrival:
    """One application hitting the cluster at ``t_arrival``.

    ``criticality`` is the SLO tier (higher = more critical): under
    overload or after a fault, recovery sheds tier-0 apps first and
    metrics report per-tier p99/miss columns, the mixed-criticality
    regime of arXiv:1403.8020."""

    app_id: int
    t_arrival: float
    graph: AppGraph
    deadline: float                 # absolute (model seconds)
    size_class: str                 # "small" | "large"
    criticality: int = 0            # SLO tier, higher = more critical

    @property
    def slack(self) -> float:
        return self.deadline - self.t_arrival


@dataclass
class ArrivalParams:
    rate: float = 0.02              # mean arrivals per model-second
    process: str = "poisson"        # "poisson" | "bursty"
    burst_size: int = 4
    burst_spread: float = 5.0       # seconds a burst is smeared over
    p_large: float = 0.0            # probability of a 64-core-class app
    small: SynthParams = field(default_factory=lambda: SynthParams(n_tasks=(15, 25)))
    large: SynthParams = field(default_factory=lambda: SynthParams(n_tasks=(120, 200)))
    sla_slack: tuple[float, float] = (2.0, 6.0)
    n_types: int = 1
    # P(tier k) for k = 0..len-1 (higher tier = more critical); the
    # default keeps every app tier 0, i.e. the pre-tier behaviour
    criticality_weights: tuple[float, ...] = (1.0,)

    def __post_init__(self) -> None:
        if self.process not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if not self.criticality_weights or \
                any(w < 0 for w in self.criticality_weights) or \
                sum(self.criticality_weights) <= 0:
            raise ValueError("criticality_weights must be non-negative "
                             "and sum > 0")
        # replace, don't mutate: caller-supplied SynthParams stay theirs
        self.small = dataclasses.replace(self.small, n_types=self.n_types)
        self.large = dataclasses.replace(self.large, n_types=self.n_types)


def chain_lower_bound(graph: AppGraph, ptype: int = 0) -> float:
    """Longest intra-task chain: an SLA-normalising bound no schedule
    on any machine (of that processor type) can beat."""
    return max(sum(graph.subtasks[s].time_on(ptype) for s in sids)
               for sids in graph.tasks.values())


def _arrival_times(params: ArrivalParams, n_apps: int,
                   rng: np.random.Generator) -> list[float]:
    times: list[float] = []
    t = 0.0
    if params.process == "poisson":
        for _ in range(n_apps):
            t += float(rng.exponential(1.0 / params.rate))
            times.append(t)
    else:                            # bursty
        burst_rate = params.rate / params.burst_size
        while len(times) < n_apps:
            t += float(rng.exponential(1.0 / burst_rate))
            k = min(params.burst_size, n_apps - len(times))
            offsets = np.sort(rng.uniform(0.0, params.burst_spread, size=k))
            times.extend(t + float(o) for o in offsets)
    return sorted(times[:n_apps])


def generate_workload(params: ArrivalParams, n_apps: int,
                      seed: int = 0) -> list[AppArrival]:
    """A deterministic stream of ``n_apps`` arrivals, sorted by time."""
    rng = np.random.default_rng(seed)
    times = _arrival_times(params, n_apps, rng)
    w = np.asarray(params.criticality_weights, dtype=float)
    w = w / w.sum()
    out: list[AppArrival] = []
    for i, t in enumerate(times):
        big = bool(rng.uniform() < params.p_large)
        sp = params.large if big else params.small
        # derive each app's graph seed from the stream rng so the whole
        # workload is one function of `seed`
        g = generate_app(sp, seed=int(rng.integers(0, 2**31 - 1)))
        slack = float(rng.uniform(*params.sla_slack))
        lb = chain_lower_bound(g)
        out.append(AppArrival(app_id=i, t_arrival=t, graph=g,
                              deadline=t + slack * lb,
                              size_class="large" if big else "small",
                              # guard keeps the single-tier rng stream
                              # identical to the pre-tier generator
                              criticality=(int(rng.choice(len(w), p=w))
                                           if len(w) > 1 else 0)))
    return out
