# Population-based mapping search over the scenario array IR: mapping
# vectors + the task-coherent decoder (encoding.py), the bias-elitist
# GA with batched simulate_batch fitness (ga.py; on the card through the
# sim_relax_pop kernel by default), the hill-climbing single-task-move
# refiner (local.py), and the device-resident loop (device.py: decode,
# fitness and selection as tensor ops on one device, GAParams(device=True)).
# The core registry exposes the GA as SCHEDULERS["ga"] via a lazy
# wrapper, so importing repro_torch.core is enough to reach it by name.
from .device import (DevicePopulation, device_inputs, ga_search_device,
                     population_fitness_device)
from .encoding import decode, decode_population, encode, task_ids, topo_order
from .ga import GAParams, ga_schedule, ga_search, population_fitness
from .local import hill_climb, hill_climb_device

__all__ = [
    "GAParams", "ga_schedule", "ga_search", "population_fitness",
    "decode", "decode_population", "encode", "task_ids", "topo_order",
    "hill_climb", "hill_climb_device",
    "DevicePopulation", "device_inputs", "ga_search_device",
    "population_fitness_device",
]
