"""Lower the model stack into the scheduler's own IR (MPAHA AppGraphs).

Two graph shapes, both plain :class:`repro_torch.core.mpaha.AppGraph` — valid
under ``finalize()``'s acyclicity check and round-trippable through
``repro_torch.core.lowering`` like every synthetic scenario:

**Pipeline chain graph** (``pipeline_graph``): one *task per pipeline
stage* — MPAHA task coherence (a task runs wholly on one core) is
exactly the weight-residency constraint (a stage's layers live on one
device). Each stage task's ordered subtask chain is its *microbatch
ticks*: subtask ``(s, m)`` = stage ``s`` processing microbatch ``m``,
and the cross-task edges ``(s, m) -> (s+1, m)`` carry one microbatch of
activations. This is the honest pipeline DAG: mapping every stage to one
core serializes to ``n_micro * sum(t_stage)``, spreading stages overlaps
microbatches — so AMTHA/GA see the *pipelining benefit and the comm
penalty at once* and can trade them (the single-chain graph of
``core/placement.assign_layers_to_pods`` degenerates to one core because
it models neither).

**MoE expert graph** (``moe_graph``): fan-out/fan-in — a dispatch task,
one task per expert sized by its routed load, a combine task; dispatch ->
expert and expert -> combine edges carry that expert's routed token
bytes. AMTHA's processor selection balances expert load while the comm
matrix penalizes placing hot experts across slow links.
"""

from __future__ import annotations

from ..configs import ModelConfig
from ..core.machine import MachineModel
from ..core.mpaha import AppGraph
from .costs import (UnitCosts, exec_times, expert_flops_per_token,
                    unit_costs)

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def default_stages(n_units: int, n_cores: int) -> int:
    """Largest stage count that tiles the repeat units and fits the
    machine — the executable layout requires equal contiguous stages."""
    return max(s for s in range(1, min(n_units, n_cores) + 1)
               if n_units % s == 0)


def stage_splits(n_units: int, n_stages: int) -> list[int]:
    """Balanced contiguous partition of the repeat units: the first
    ``n_units % n_stages`` stages take one extra unit. Equal exactly
    when ``n_stages`` divides ``n_units`` (the executable case)."""
    base, rem = divmod(n_units, n_stages)
    return [base + (1 if s < rem else 0) for s in range(n_stages)]


def pipeline_graph(costs: UnitCosts, machine: MachineModel, *,
                   n_stages: int | None = None,
                   n_micro: int = 8) -> AppGraph:
    """The pipeline DAG of ``costs``'s model on ``machine``.

    Tasks ``0..n_stages-1`` are stages (balanced contiguous unit
    groups, per ``stage_splits`` — exactly equal in the executable
    case); task ``s``'s chain holds ``n_micro`` subtasks whose exec
    time is the stage's roofline time for one microbatch on each
    processor type; edges ``(s, m) -> (s+1, m)`` carry
    ``costs.act_bytes``."""
    if n_stages is None:
        n_stages = default_stages(costs.n_units, machine.n_cores)
    if not 1 <= n_stages <= costs.n_units:
        raise ValueError(f"{n_stages} stages for {costs.n_units} units")
    if n_stages > machine.n_cores:
        raise ValueError(f"{n_stages} stages > {machine.n_cores} cores")
    splits = stage_splits(costs.n_units, n_stages)
    g = AppGraph(n_types=machine.n_types)
    sids = []
    for s in range(n_stages):
        times = exec_times(costs.flops * splits[s],
                           costs.hbm_bytes * splits[s], machine)
        sids.append(g.add_task(s, [times] * n_micro))
    for s in range(n_stages - 1):
        for m in range(n_micro):
            g.add_edge(sids[s][m], sids[s + 1][m], costs.act_bytes)
    g.finalize()
    return g


def model_pipeline_graph(cfg: ModelConfig, machine: MachineModel, *,
                         seq: int = 1024, micro_batch: int = 1,
                         n_stages: int | None = None, n_micro: int = 8,
                         source: str = "analytic"
                         ) -> tuple[AppGraph, UnitCosts]:
    """One-call lowering: config -> costs -> pipeline AppGraph."""
    c = unit_costs(cfg, seq=seq, micro_batch=micro_batch, source=source)
    return pipeline_graph(c, machine, n_stages=n_stages,
                          n_micro=n_micro), c


def moe_graph(cfg: ModelConfig, machine: MachineModel,
              loads_tokens: list[float], *,
              router_tokens: float | None = None) -> AppGraph:
    """Expert fan-out/fan-in graph for one MoE layer.

    ``loads_tokens[e]`` = routed token copies expert ``e`` receives.
    Task 0 = dispatch (router pass over all tokens), tasks ``1..E`` =
    experts (load-proportional FFN time), task ``E+1`` = combine
    (weighted sum back into the token stream). Edge volumes are the
    routed activation bytes of each expert."""
    e = cfg.n_experts
    assert e and len(loads_tokens) == e, "one load per expert"
    total = router_tokens if router_tokens is not None \
        else max(sum(loads_tokens) / max(cfg.top_k, 1), 1.0)
    dbytes = _DTYPE_BYTES.get(cfg.dtype, 2)
    per_tok = expert_flops_per_token(cfg)
    router_flops = 2.0 * cfg.d_model * e * total
    combine_flops = 2.0 * cfg.d_model * sum(loads_tokens)

    g = AppGraph(n_types=machine.n_types)
    disp = g.add_task(0, [exec_times(router_flops, 0.0, machine)])[0]
    expert_sids = []
    for i, load in enumerate(loads_tokens):
        fl = max(load, 1.0) * per_tok
        hbm = per_tok / 2 * dbytes          # expert weights resident
        expert_sids.append(
            g.add_task(1 + i, [exec_times(fl, hbm, machine)])[0])
    comb = g.add_task(e + 1, [exec_times(combine_flops, 0.0, machine)])[0]
    for i, load in enumerate(loads_tokens):
        vol = max(load, 1.0) * cfg.d_model * dbytes
        g.add_edge(disp, expert_sids[i], vol)
        g.add_edge(expert_sids[i], comb, vol)
    g.finalize()
    return g


def graph_total_flops(graph: AppGraph, machine: MachineModel) -> float:
    """Invert the roofline on type 0 to recover the FLOP total the graph
    encodes — the bookkeeping check against the counted source (valid when
    the compute term dominates, which the tests arrange)."""
    from .costs import type_speed_vectors
    speeds, _ = type_speed_vectors(machine)
    return sum(st.times[0] * speeds[0] for st in graph.subtasks)
