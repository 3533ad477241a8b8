"""repro_torch.autoplace — AMTHA places the port's own model stack.

Closes the loop between the two halves of the port: the model stack
(``configs``/``models``/``runtime``/``sharding``) becomes a scheduling
*application* — per-stage costs from ``costs``, an MPAHA ``AppGraph``
from ``graph``, a searched placement applied back to the executable
pipeline/sharding from ``apply``, on nodes of H100 GPUs
(``core.machine.h100_node``)::

    from repro_torch import autoplace
    plan = autoplace.place("gemma2_2b", scheduler="ga")
    mesh = autoplace.stage_mesh(plan.stage_to_device)
"""

from .apply import (ExpertPlan, PipelinePlan, place, place_moe_experts,
                    place_pipeline, resolve_config, stage_mesh)
from .costs import (UnitCosts, exec_times, expert_flops_per_token,
                    layer_flops_analytic, type_speed_vectors, unit_costs)
from .graph import (default_stages, graph_total_flops, model_pipeline_graph,
                    moe_graph, pipeline_graph, stage_splits)

__all__ = [
    "ExpertPlan", "PipelinePlan", "UnitCosts",
    "default_stages", "exec_times", "expert_flops_per_token",
    "graph_total_flops", "layer_flops_analytic", "model_pipeline_graph",
    "moe_graph", "pipeline_graph", "place", "place_moe_experts",
    "place_pipeline", "resolve_config", "stage_mesh", "stage_splits",
    "type_speed_vectors", "unit_costs",
]
