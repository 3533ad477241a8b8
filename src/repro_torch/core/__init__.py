# The paper's MPAHA application model and AMTHA mapper with the machinery
# to evaluate them (machine models, the HEFT/ETF baselines, the
# discrete-event simulators and the threaded executor, the §5.1
# synthetic-app generator), mirrored module for module from the JAX
# package. The host algorithms stay on the host in NumPy; the batched simulator (core/sim_engine.py) evaluates a
# whole suite in one call on the card through the hand-written
# ``sim_relax_pop`` kernel (the dense ``sim_step`` kernel relaxes the same
# batch from ``dense_lags``). The placement layer (core/placement.py) maps
# experts and layer blocks onto nodes of H100 GPUs (``h100_node``) with
# AMTHA.
from .amtha import AMTHA, amtha_schedule
from .convert import graph_from, machine_from, schedule_from
from .engine import ArrayAMTHA, engine_schedule
from .executor import ExecResult, execute_threaded
from .heft import etf_schedule, heft_schedule
from .lowering import (FaultArrays, GraphArrays, MachineArrays,
                       PopulationArrays, ScenarioArrays, ScenarioBatch,
                       batch_scenarios, dense_lags, drain_matrix,
                       graph_arrays, lower_faults, lower_population,
                       lower_scenario, machine_arrays, population_arrays,
                       repeat_batch)
from .machine import (CommLevel, MachineModel, cluster_of_multicores,
                      dell_poweredge_1950, h100_node, heterogeneous_cluster,
                      hp_bl260c)
from .mpaha import AppGraph, CommEdge, Subtask, merge_graphs
from .placement import (assign_layers_to_pods, place_experts,
                        round_robin_placement)
from .registry import (SCHEDULERS, SIMULATORS, Scheduler, get_scheduler,
                       get_simulator, register_scheduler, register_simulator,
                       scheduler_entry)
from .schedule import Schedule, ScheduleError, validate
from .sim_engine import (BatchSimResult, simulate_arrays, simulate_batch,
                         simulate_scenario, simulate_suite)
from .simulator import SimResult, simulate
from .synth import (SynthParams, generate_app, paper_suite_8core,
                    paper_suite_64core)
from .timeline import Timeline

__all__ = [
    "AMTHA", "amtha_schedule", "ArrayAMTHA", "engine_schedule", "Timeline",
    "AppGraph", "CommEdge", "Subtask", "merge_graphs",
    "CommLevel", "MachineModel", "cluster_of_multicores",
    "dell_poweredge_1950", "hp_bl260c", "heterogeneous_cluster",
    "h100_node", "place_experts", "round_robin_placement",
    "assign_layers_to_pods",
    "Schedule", "ScheduleError", "validate", "SimResult", "simulate",
    "ExecResult", "execute_threaded",
    "heft_schedule", "etf_schedule", "SynthParams", "generate_app",
    "paper_suite_8core", "paper_suite_64core",
    "graph_from", "machine_from", "schedule_from",
    # scenario IR + array/batched simulation
    "FaultArrays", "GraphArrays", "MachineArrays", "PopulationArrays",
    "ScenarioArrays", "ScenarioBatch", "batch_scenarios", "dense_lags",
    "drain_matrix", "graph_arrays", "lower_faults", "lower_population",
    "lower_scenario", "machine_arrays", "population_arrays",
    "repeat_batch",
    "BatchSimResult", "simulate_arrays", "simulate_batch",
    "simulate_scenario", "simulate_suite",
    # scheduler/simulator registry
    "Scheduler", "SCHEDULERS", "SIMULATORS", "get_scheduler",
    "get_simulator", "register_scheduler", "register_simulator",
    "scheduler_entry",
]
