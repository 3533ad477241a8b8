# Population-based mapping search over the scenario array IR, host
# half: mapping vectors + the task-coherent decoder (encoding.py), the
# bias-elitist GA with batched simulate_batch fitness (ga.py; on the
# card through the sim_relax_pop kernel by default) and the
# hill-climbing single-task-move refiner (local.py). The reference's
# device-resident loop (GAParams(device=True), hill_climb_device) is
# not ported yet and raises. The core registry exposes the GA as
# SCHEDULERS["ga"] via a lazy wrapper, so importing repro_torch.core is
# enough to reach it by name.
from .encoding import decode, decode_population, encode, task_ids, topo_order
from .ga import GAParams, ga_schedule, ga_search, population_fitness
from .local import hill_climb, hill_climb_device

__all__ = [
    "GAParams", "ga_schedule", "ga_search", "population_fitness",
    "decode", "decode_population", "encode", "task_ids", "topo_order",
    "hill_climb", "hill_climb_device",
]
