"""Admission & queueing policies over the incremental scheduler.

A policy decides *when* and *in what order* queued applications are
handed to :class:`~repro_torch.online.online_amtha.OnlineAMTHA`:

* **FIFO** — admit each app the instant it arrives. Zero queueing
  delay, but a huge early app can wall off the cores that a small
  urgent one needs.
* **RankPriority** — batch up to ``k`` arrivals, then admit in
  descending total rank (the sum of Eq. 2 averages over the whole app —
  the natural extension of the paper's §3.2 task rank to whole
  applications): heaviest work is placed while the timeline still has
  big holes.
* **Batched** — re-map every ``k`` arrivals using the *concurrent
  evaluation path*: every queued app is scored against the same frozen
  snapshot of the timeline, then commits happen
  shortest-predicted-response-first (SJF), which minimises mean response
  within the batch. Two scorers share that contract:

  - ``scorer="exact"`` (default) — one transactional AMTHA what-if per
    app on the live timeline (``begin``/``rollback``, no copies); the
    evaluations are independent, so they could run on worker
    threads/cores;
  - ``scorer="kernel"`` — the whole ``(apps × cores)`` candidate matrix
    is scored in **one** ``sched_score`` call (drain-on-one-core
    completion estimates against the per-core frontiers) — a screening
    pass whose cost does not grow with timeline length at all. On a
    CUDA ``device`` (the default) that is the hand-written kernel
    ``kernels/csrc/sched_score.cu``; ``device="cpu"`` runs its plain
    PyTorch version. Ordering may differ from the exact scorer where
    drain estimates invert true what-if finishes; every admission itself
    still runs the exact engine.

All policies share one invariant: a queued app's release floor is its
admission instant, never earlier, so the produced timeline is causal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lowering import drain_matrix
from ..core.machine import MachineModel
from ..kernels import ops
from .arrivals import AppArrival
from .online_amtha import OnlineAMTHA
from .state import ClusterState


def app_rank(arrival: AppArrival, machine: MachineModel) -> float:
    """Whole-app rank: sum of W_avg (paper Eq. 2) over every subtask."""
    counts = machine.type_counts()
    return sum(st.w_avg_over(counts) for st in arrival.graph.subtasks)


class Policy:
    name = "abstract"

    def __init__(self, validate_each: bool = False, use_engine: bool = True):
        self.validate_each = validate_each
        self.use_engine = use_engine        # False -> seed copy/merge oracle

    # -- subclass hooks --------------------------------------------------
    def batch_size(self) -> int:
        return 1

    def order_batch(self, batch: list[AppArrival], eng: OnlineAMTHA,
                    now: float) -> list[AppArrival]:
        return batch

    # -- admission loop --------------------------------------------------
    def run(self, machine: MachineModel,
            workload: list[AppArrival]) -> ClusterState:
        eng = OnlineAMTHA(machine, use_engine=self.use_engine)
        pending: list[AppArrival] = []
        stream = sorted(workload, key=lambda a: a.t_arrival)
        for i, arr in enumerate(stream):
            pending.append(arr)
            last = i == len(stream) - 1
            if len(pending) >= self.batch_size() or last:
                now = arr.t_arrival         # batch closes at this arrival
                for a in self.order_batch(pending, eng, now):
                    eng.admit(a, at=now)
                    if self.validate_each:
                        eng.state.validate()
                pending = []
        return eng.state


class FIFOPolicy(Policy):
    name = "fifo"


class RankPriorityPolicy(Policy):
    """Admit heaviest-rank-first within each batch of ``k`` arrivals."""

    name = "rank"

    def __init__(self, k: int = 4, validate_each: bool = False,
                 use_engine: bool = True):
        super().__init__(validate_each, use_engine)
        self.k = k

    def batch_size(self) -> int:
        return self.k

    def order_batch(self, batch, eng, now):
        return sorted(batch, key=lambda a: -app_rank(a, eng.machine))


class BatchedPolicy(Policy):
    """Re-map every ``k`` arrivals via concurrent what-if evaluation:
    score each queued app on a frozen snapshot, commit SJF."""

    name = "batched"

    def __init__(self, k: int = 4, validate_each: bool = False,
                 scorer: str = "exact", use_engine: bool = True,
                 device: str | torch.device = "cuda"):
        super().__init__(validate_each, use_engine)
        if scorer not in ("exact", "kernel"):
            raise ValueError(f"unknown scorer {scorer!r}")
        self.k = k
        self.scorer = scorer
        self.device = torch.device(device)     # where the kernel scorer runs

    def batch_size(self) -> int:
        return self.k

    def order_batch(self, batch, eng, now):
        if self.scorer == "kernel":
            scores = self.kernel_scores(batch, eng, now)
            scored = [(s, a.app_id, a) for s, a in zip(scores, batch)]
        else:
            # independent transactional what-ifs against the same
            # snapshot (each predict() journals and rewinds the live
            # timeline, so the evaluations do not see each other)
            scored = [(eng.predict(a, at=now) - now, a.app_id, a)
                      for a in batch]
        return [a for _, _, a in sorted(scored, key=lambda s: s[:2])]

    def kernel_scores(self, batch, eng, now) -> list[float]:
        """One batched ``sched_score`` call over the (apps × cores)
        candidate matrix on ``self.device``; per-app score = best core's
        drain estimate, relative to ``now`` like the exact scorer. The
        drain matrix comes off the shared scenario IR
        (``core.lowering``). Drains, frontiers and releases are cast to
        float32 on the host before the max, the row minimum is taken on
        the host from the downloaded matrix, and ``- now`` in float64.
        A CUDA device launches the kernel or raises."""
        drain = drain_matrix([a.graph for a in batch], eng.machine)
        frontiers = eng.state.frontiers()
        release = [max(now, a.t_arrival) for a in batch]
        # row-major copies: the drain gather comes out column-major
        args = [torch.from_numpy(np.ascontiguousarray(x, np.float32))
                .to(self.device) for x in (drain, frontiers, release)]
        matrix = ops.sched_score(*args).cpu().numpy()
        return [float(v) - now for v in matrix.min(axis=1)]


class CriticalityPolicy(Policy):
    """Admit highest criticality tier first within each batch of ``k``
    arrivals (heaviest rank breaking ties within a tier), so critical
    apps grab the timeline's holes before best-effort work walls them
    off — the admission-side complement of recovery's shed-low-first."""

    name = "critical"

    def __init__(self, k: int = 4, validate_each: bool = False,
                 use_engine: bool = True):
        super().__init__(validate_each, use_engine)
        self.k = k

    def batch_size(self) -> int:
        return self.k

    def order_batch(self, batch, eng, now):
        return sorted(batch, key=lambda a: (-a.criticality,
                                            -app_rank(a, eng.machine)))


POLICIES = {p.name: p for p in (FIFOPolicy, RankPriorityPolicy,
                                BatchedPolicy, CriticalityPolicy)}


def make_policy(name: str, k: int = 4, validate_each: bool = False,
                scorer: str = "exact", use_engine: bool = True,
                device: str | torch.device = "cuda") -> Policy:
    """The named policy; ``device`` is where ``batched``'s kernel scorer
    runs (the other policies score nothing on a device)."""
    if name == "fifo":
        return FIFOPolicy(validate_each, use_engine)
    if name == "rank":
        return RankPriorityPolicy(k, validate_each, use_engine)
    if name == "batched":
        return BatchedPolicy(k, validate_each, scorer=scorer,
                             use_engine=use_engine, device=device)
    if name == "critical":
        return CriticalityPolicy(k, validate_each, use_engine)
    raise ValueError(f"unknown policy {name!r} (have {sorted(POLICIES)})")
