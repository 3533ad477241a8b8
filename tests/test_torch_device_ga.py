"""The port's device-resident GA on the CPU against the JAX package's
``search/device.py``: the decode gathers and both fitness paths on the
same NumPy gene matrices, and the GA's invariants (the counterparts of
``tests/test_search.py``'s device-GA tests).

Tolerances: the decode is gathers and one float32 division, and fitness
is ``+`` and ``max`` only, so the gather inputs and the fitness of both
paths (``scan``, and ``kernel`` through ``sim_relax_pop``'s plain
version) equal the reference's bit for bit. Against the host
append-only decode simulated in float64 the float32 fitness is held to
rtol 1e-5, the reference's float32 tolerance. The GA's draws come from a
``torch.Generator``, which cannot reproduce ``jax.random``'s stream, so
the searches are compared on invariants, not on their winners.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro.search.device as RD
import repro_torch.core as T
import repro_torch.search as TS
import repro_torch.search.device as TD
from repro_torch.kernels import ops, ref

RTOL_F32 = 1e-5
FAST_DEV = dict(pop_size=12, generations=6, refine_rounds=1, refine_moves=12,
                device=True, backend="torch")


def app(pkg, seed, tasks=(10, 16), n_types=1):
    return pkg.generate_app(pkg.SynthParams(n_tasks=tasks, n_types=n_types),
                            seed)


MACHINES = {"8core": lambda pkg: pkg.dell_poweredge_1950(),
            "16core-hetero": lambda pkg: pkg.cluster_of_multicores(
                n_blades=2, n_types=2),
            "64core": lambda pkg: pkg.hp_bl260c()}


def pair(kind, seed):
    n_types = 2 if "hetero" in kind else 1
    return ((app(R, seed, n_types=n_types), MACHINES[kind](R)),
            (app(T, seed, n_types=n_types), MACHINES[kind](T)))


def genes(graph, machine, b=16, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, machine.n_cores, (b, len(graph.tasks)),
                        dtype=np.int32)


def floors(graph, t=40.0):
    return {s: t for s in range(0, graph.n_subtasks, 2)}


@pytest.mark.parametrize("kind", sorted(MACHINES))
@pytest.mark.parametrize("with_floors", [False, True])
def test_device_inputs_and_gather_inputs_equal_reference(kind, with_floors):
    (gr, mr), (gt, mt) = pair(kind, 2)
    rel = floors(gt) if with_floors else None
    ir, it = RD.device_inputs(gr, mr, releases=rel), \
        TD.device_inputs(gt, mt, releases=rel, device="cpu")
    for name in TD.DevicePopulation._fields:
        np.testing.assert_array_equal(getattr(it, name).numpy(),
                                      np.asarray(getattr(ir, name)),
                                      err_msg=name)
    pop = genes(gt, mt)
    want = [np.asarray(x) for x in
            RD.population_gather_inputs(ir, jnp.asarray(pop))]
    got = TD.population_gather_inputs(it, torch.from_numpy(pop))
    assert [x.dtype for x in got] == [torch.int32] + [torch.float32] * 4
    for name, a, b in zip(("pred", "lat", "volbw", "duration", "release"),
                          got, want):
        assert a.is_contiguous(), name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("kind", sorted(MACHINES))
@pytest.mark.parametrize("method", ["scan", "kernel"])
def test_fitness_equals_reference_bit_for_bit(kind, method):
    """Both fitness paths against the reference's (its scan and its
    Pallas kernel in interpret mode) and the NumPy oracle
    ``pop_relax_np``, on the same gene matrix, with release floors."""
    (gr, mr), (gt, mt) = pair(kind, 5)
    rel = floors(gt, 12.5)
    ir = RD.device_inputs(gr, mr, releases=rel)
    it = TD.device_inputs(gt, mt, releases=rel, device="cpu")
    pop = genes(gt, mt, seed=7)
    got = TD.population_fitness_device(it, torch.from_numpy(pop),
                                       method=method)
    assert got.dtype == torch.float32 and got.shape == (len(pop),)
    want = np.asarray(RD.population_fitness_device(ir, jnp.asarray(pop),
                                                   method=method))
    np.testing.assert_array_equal(got.numpy(), want)
    gathered = [x.numpy() for x in
                TD.population_gather_inputs(it, torch.from_numpy(pop))]
    oracle = ref.pop_relax_np(*gathered, n_steps=it.n_subtasks)
    np.testing.assert_array_equal(got.numpy(), oracle.max(axis=1))


def test_scan_and_kernel_ends_equal_and_kernel_counts_no_cpu_launch():
    (_, _), (gt, mt) = pair("8core", 3)
    it = TD.device_inputs(gt, mt, device="cpu")
    pop = torch.from_numpy(genes(gt, mt, b=9, seed=3))
    before = ops.sim_relax_pop.launches
    assert torch.equal(TD.population_ends(it, pop),
                       TD.population_ends_kernel(it, pop))
    assert ops.sim_relax_pop.launches == before


def test_prev_on_core_is_a_stable_grouping():
    """Equal cores keep topo order: the in-order edge links each subtask
    to the nearest earlier one on its core."""
    core = torch.tensor([[2, 0, 2, 2, 0, 1], [1, 1, 1, 1, 1, 1]])
    got = TD._prev_on_core(core, 6)
    assert got.tolist() == [[6, 6, 0, 2, 1, 6], [6, 0, 1, 2, 3, 4]]


@pytest.mark.parametrize("seed", [2, 7])
def test_fitness_matches_host_appendonly_decode(seed):
    """Device fitness == lowering + simulating the host append-only
    decode (``gap_fill=False``) of the same genes, up to float32."""
    g, m = app(T, seed), T.dell_poweredge_1950()
    pop = genes(g, m, seed=seed)
    fit = TD.population_fitness_device(TD.device_inputs(g, m, device="cpu"),
                                       torch.from_numpy(pop)).numpy()
    scheds = TS.decode_population(g, m, pop, gap_fill=False)
    host = T.simulate_batch(T.lower_population(g, m, scheds),
                            backend="numpy").t_exec
    np.testing.assert_allclose(fit, host, rtol=RTOL_F32, atol=1e-3)
    T.validate(scheds[0], g, m, require_task_coherence=True)


def test_fitness_respects_release_floors():
    g, m = app(T, 3), T.dell_poweredge_1950()
    rel = {s: 40.0 for s in range(g.n_subtasks)}
    pop = genes(g, m, b=4, seed=3)
    fit = TD.population_fitness_device(
        TD.device_inputs(g, m, releases=rel, device="cpu"),
        torch.from_numpy(pop)).numpy()
    scheds = TS.decode_population(g, m, pop, releases=rel, gap_fill=False)
    host = T.simulate_batch(T.lower_population(g, m, scheds, releases=rel),
                            backend="numpy").t_exec
    np.testing.assert_allclose(fit, host, rtol=RTOL_F32, atol=1e-3)
    assert fit.min() >= 40.0


def test_device_inputs_refuse_unknown_release_and_lint_first():
    g, m = app(T, 1), T.dell_poweredge_1950()
    with pytest.raises(ValueError, match="unknown subtask"):
        TD.device_inputs(g, m, releases={g.n_subtasks: 1.0}, device="cpu")
    with pytest.raises(ValueError, match="fitness method"):
        TD.population_fitness_device(TD.device_inputs(g, m, device="cpu"),
                                     torch.zeros((1, len(g.tasks)),
                                                 dtype=torch.int32),
                                     method="pallas")


def test_device_ga_deterministic_under_seed():
    g, m = app(T, 1), T.dell_poweredge_1950()
    par = TS.GAParams(**FAST_DEV)
    v1, f1 = TS.ga_search(g, m, seed=7, params=par)
    v2, f2 = TS.ga_search(g, m, seed=7, params=par)
    assert v1.dtype == np.int32 and np.array_equal(v1, v2) and f1 == f2
    v3, _ = TS.ga_search(g, m, seed=8, params=par)
    assert not np.array_equal(v1, v3)


def test_device_ga_improves_on_initial_population():
    g, m = app(T, 4), T.dell_poweredge_1950()
    # ga_search_device draws its first population first from its generator
    gen = torch.Generator().manual_seed(9)
    first = torch.randint(0, m.n_cores, (FAST_DEV["pop_size"], len(g.tasks)),
                          generator=gen, dtype=torch.int32)
    init_best = float(TD.population_fitness_device(
        TD.device_inputs(g, m, device="cpu"), first).min())
    _, val = TS.ga_search(g, m, seed=9, params=TS.GAParams(**FAST_DEV))
    assert val <= init_best + 1e-6


def test_device_ga_kernel_method_searches_like_the_scan():
    """On the CPU the kernel method runs ``sim_relax_pop``'s plain
    version; its fitness equals the scan's bit for bit, so the same
    seed reaches the same winner."""
    g, m = app(T, 6), T.dell_poweredge_1950()
    par = TS.GAParams(**FAST_DEV)
    got = TD.ga_search_device(g, m, seed=3, params=par, method="kernel")
    want = TD.ga_search_device(g, m, seed=3, params=par, method="scan")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("machine_fn,tasks", [
    (T.hp_bl260c, (40, 60)),                              # 64 cores
    (lambda: T.cluster_of_multicores(8), (60, 80)),       # 64, 3-level comm
])
def test_device_ga_invariant_on_large_machines(machine_fn, tasks):
    """``ga <= engine`` survives the device routing: the winner is
    re-decoded with the gap-filling host decoder and the result is never
    worse than the engine baseline."""
    m = machine_fn()
    g = T.generate_app(T.SynthParams(n_tasks=tasks), 31)
    eng = T.get_scheduler("engine")(g, m)
    par = TS.GAParams(pop_size=12, generations=4, refine_rounds=1,
                      refine_moves=12, device=True, backend="torch")
    ga = TS.ga_schedule(g, m, seed=0, params=par)
    T.validate(ga, g, m, require_task_coherence=True)
    assert ga.makespan() <= eng.makespan() + 1e-9


def test_device_ga_respects_release_floors():
    g, m = app(T, 6), T.dell_poweredge_1950()
    rel = {s: 25.0 for s in range(g.n_subtasks)}
    sch = TS.ga_schedule(g, m, seed=0, params=TS.GAParams(**FAST_DEV),
                         releases=rel)
    T.validate(sch, g, m, require_task_coherence=True)
    assert min(p.start for p in sch.placements.values()) >= 25.0 - 1e-9


def test_device_ga_elites_seed_the_population():
    """An elite vector rides in row 0 and survives every generation, so
    the search is never worse than the elite's own fitness."""
    g, m = app(T, 2), T.dell_poweredge_1950()
    elite = TS.encode(g, T.engine_schedule(g, m))
    inp = TD.device_inputs(g, m, device="cpu")
    elite_fit = float(TD.population_fitness_device(
        inp, torch.from_numpy(elite[None]))[0])
    _, val = TS.ga_search(g, m, seed=0, params=TS.GAParams(**FAST_DEV),
                          elites=[elite])
    assert val <= elite_fit


def test_generation_step_keeps_elites_and_shape():
    g, m = app(T, 2), T.dell_poweredge_1950()
    inp = TD.device_inputs(g, m, device="cpu")
    pop = torch.from_numpy(genes(g, m, b=10, seed=4))
    fit = TD.population_fitness_device(inp, pop)
    step = TD.generation_step(TS.GAParams(**FAST_DEV), n_tasks=len(g.tasks),
                              n_cores=m.n_cores)
    new, new_fit = step(inp, torch.Generator().manual_seed(0), pop, fit)
    assert new.shape == pop.shape and new.dtype == torch.int32
    best = torch.argsort(fit, stable=True)[:2]
    assert torch.equal(new[:2], pop[best])
    assert torch.equal(new_fit[:2], fit[best])
    assert int(new.min()) >= 0 and int(new.max()) < m.n_cores


def test_hill_climb_device_never_worse_and_deterministic():
    g, m = app(T, 5), T.dell_poweredge_1950()
    inp = TD.device_inputs(g, m, device="cpu")
    vec = genes(g, m, b=1, seed=11)[0]
    fit = float(TD.population_fitness_device(inp,
                                             torch.from_numpy(vec[None]))[0])

    def climb(seed):
        return TS.hill_climb_device(TD.population_fitness_device, inp, vec,
                                    fit, generator=torch.Generator()
                                    .manual_seed(seed), rounds=4, moves=20,
                                    n_cores=m.n_cores)

    v1, f1 = climb(1)
    v2, f2 = climb(1)
    assert np.array_equal(v1, v2) and f1 == f2 and f1 <= fit
    got = float(TD.population_fitness_device(inp,
                                             torch.from_numpy(v1[None]))[0])
    assert got == f1
    assert (v1 != vec).sum() <= 4          # one move per accepted round
    one = TS.hill_climb_device(TD.population_fitness_device, inp, vec, fit,
                               generator=torch.Generator(), n_cores=1)
    assert np.array_equal(one[0], vec) and one[1] == fit


def test_device_gaparams_validated_and_routed():
    with pytest.raises(ValueError, match="numpy"):
        TS.GAParams(device=True, backend="numpy")
    assert TS.GAParams(device=True).backend == "cuda"


def test_device_ga_defaults_to_the_card(monkeypatch):
    """``GAParams(device=True)`` runs on the card, and raises where there
    is none instead of running anywhere else."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, m = app(T, 0), T.dell_poweredge_1950()
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ga_search(g, m, params=TS.GAParams(device=True, pop_size=4,
                                              generations=1))
