"""The port's host mapping search against the JAX package on the CPU:
encoding and decoding, population fitness, one GA generation, the GA,
the hill climber, the ``ga`` scheduler and the online ``refine_ga``, on
the same NumPy-seeded graphs, gene matrices and ``default_rng`` seeds.

Tolerances: ``backend="numpy"`` runs the reference's float64 fitness in
the same order, so vectors, fitness values and placements are compared
exactly. ``backend="torch"`` is the ``sim_relax_pop`` kernel's plain
version in float32: its fitness is held to the float64 value at
rtol 1e-5, the reference's float32 tolerance (one float32 rounding per
relaxation step).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.online as RO
import repro.search as RS
import repro_torch.core as T
import repro_torch.online as TO
import repro_torch.search as TS

RTOL_F32 = 1e-5
GA_KW = dict(pop_size=8, generations=3, refine_rounds=2, refine_moves=10)


def placements(sch):
    return {sid: (p.core, p.start, p.end) for sid, p in sch.placements.items()}


def app(pkg, seed, n_types=1):
    return pkg.generate_app(pkg.SynthParams(n_tasks=(10, 16), n_types=n_types),
                            seed)


MACHINES = {"8core": lambda pkg: pkg.dell_poweredge_1950(),
            "16core-hetero": lambda pkg: pkg.cluster_of_multicores(
                n_blades=2, n_types=2)}


def pair(kind, seed):
    n_types = 2 if "hetero" in kind else 1
    return ((app(R, seed, n_types), MACHINES[kind](R)),
            (app(T, seed, n_types), MACHINES[kind](T)))


def frozen_history(graph, machine, pkg, at_frac=0.4):
    """Placements of the engine schedule that started before
    ``at_frac`` of its makespan, and release floors for the rest."""
    sch = pkg.engine_schedule(graph, machine)
    now = at_frac * sch.makespan()
    frozen = {sid: p for sid, p in sch.placements.items() if p.start < now}
    rel = {sid: now for sid in range(graph.n_subtasks) if sid not in frozen}
    return frozen, rel


@pytest.mark.parametrize("kind", sorted(MACHINES))
def test_encoding_and_decoding_equal_reference(kind):
    (gr, mr), (gt, mt) = pair(kind, 3)
    assert TS.task_ids(gt) == RS.task_ids(gr)
    assert TS.topo_order(gt) == RS.topo_order(gr)
    sr, st = R.engine_schedule(gr, mr), T.engine_schedule(gt, mt)
    assert np.array_equal(TS.encode(gt, st), RS.encode(gr, sr))
    rng = np.random.default_rng(0)
    pop = rng.integers(0, mr.n_cores, (4, len(gr.tasks)), dtype=np.int32)
    fr, relr = frozen_history(gr, mr, R)
    ft, relt = frozen_history(gt, mt, T)
    for kw_r, kw_t in [({}, {}),
                       (dict(gap_fill=False), dict(gap_fill=False)),
                       (dict(frozen=fr, releases=relr),
                        dict(frozen=ft, releases=relt))]:
        got = TS.decode_population(gt, mt, pop, **kw_t)
        want = RS.decode_population(gr, mr, pop, **kw_r)
        assert [placements(s) for s in got] == [placements(s) for s in want]
    split = TS.decode(gt, mt, pop[0], frozen=ft, releases=relt)
    assert np.array_equal(
        TS.encode(gt, split, strict=False),
        RS.encode(gr, RS.decode(gr, mr, pop[0], frozen=fr, releases=relr),
                  strict=False))


@pytest.mark.parametrize("kind", sorted(MACHINES))
def test_population_fitness_and_generation_equal_reference(kind):
    (gr, mr), (gt, mt) = pair(kind, 5)
    rng = np.random.default_rng(1)
    pop = rng.integers(0, mr.n_cores, (12, len(gr.tasks)), dtype=np.int32)
    fr, relr = frozen_history(gr, mr, R)
    ft, relt = frozen_history(gt, mt, T)
    for kw_r, kw_t in [({}, {}), (dict(frozen=fr, releases=relr),
                                  dict(frozen=ft, releases=relt))]:
        want = RS.population_fitness(gr, mr, pop, **kw_r)
        got = TS.population_fitness(gt, mt, pop, backend="numpy", **kw_t)
        assert np.array_equal(got, want)
        f32 = TS.population_fitness(gt, mt, pop, backend="torch", **kw_t)
        np.testing.assert_allclose(f32, want, rtol=RTOL_F32, atol=0.0)
    kw = dict(GA_KW, pop_size=len(pop))
    par_r, par_t = RS.GAParams(**kw), TS.GAParams(backend="numpy", **kw)
    nxt_r = RS.ga.next_generation(pop, want, np.random.default_rng(9), par_r,
                                  p_mut=0.1, n_cores=mr.n_cores)
    nxt_t = TS.ga.next_generation(pop, want, np.random.default_rng(9), par_t,
                                  p_mut=0.1, n_cores=mt.n_cores)
    assert np.array_equal(nxt_t, nxt_r)


@pytest.mark.parametrize("kind", sorted(MACHINES))
@pytest.mark.parametrize("seed", [0, 7])
def test_ga_search_and_schedule_equal_reference(kind, seed):
    (gr, mr), (gt, mt) = pair(kind, seed)
    elite_r = RS.encode(gr, R.engine_schedule(gr, mr))
    elite_t = TS.encode(gt, T.engine_schedule(gt, mt))
    vr, fr = RS.ga_search(gr, mr, seed=seed, params=RS.GAParams(**GA_KW),
                          elites=[elite_r])
    vt, ft = TS.ga_search(gt, mt, seed=seed,
                          params=TS.GAParams(backend="numpy", **GA_KW),
                          elites=[elite_t])
    assert np.array_equal(vt, vr) and ft == fr
    v32, f32 = TS.ga_search(gt, mt, seed=seed,
                            params=TS.GAParams(backend="torch", **GA_KW),
                            elites=[elite_t])
    np.testing.assert_allclose(f32, fr, rtol=RTOL_F32, atol=0.0)
    rel = {0: 2.0, 3: 5.5}
    want = RS.ga_schedule(gr, mr, seed=seed, params=RS.GAParams(**GA_KW),
                          releases=rel)
    got = TS.ga_schedule(gt, mt, seed=seed,
                         params=TS.GAParams(backend="numpy", **GA_KW),
                         releases=rel)
    assert placements(got) == placements(want)
    by_name = T.get_scheduler("ga")(gt, mt, seed=seed, backend="numpy",
                                    **GA_KW)
    assert placements(by_name) == placements(
        R.get_scheduler("ga")(gr, mr, seed=seed, **GA_KW))
    assert T.scheduler_entry("ga").task_coherent


def test_hill_climb_equals_reference():
    (gr, mr), (gt, mt) = pair("16core-hetero", 2)
    vec = RS.encode(gr, R.engine_schedule(gr, mr))
    fit = float(RS.population_fitness(gr, mr, vec[None])[0])
    want = RS.hill_climb(gr, mr, vec.copy(), fit,
                         rng=np.random.default_rng(4), rounds=3, moves=20)
    got = TS.hill_climb(gt, mt, vec.copy(), fit,
                        rng=np.random.default_rng(4), rounds=3, moves=20,
                        backend="numpy")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_frozen_device_ga_stays_on_the_host_like_the_reference():
    """With ``frozen`` history ``GAParams(device=True)`` runs the host
    loop in both packages: the same search as ``device=False``. The
    device loop needs a torch backend (``"numpy"`` is refused), so the
    port's runs take the plain float32 fitness (``backend="torch"``),
    held to the reference's at float32 tolerance; the port's float64
    host search (``backend="numpy"``) equals the reference's exactly."""
    (gr, mr), (gt, mt) = pair("8core", 4)
    fr, relr = frozen_history(gr, mr, R)
    ft, relt = frozen_history(gt, mt, T)
    runs = []
    for device in (True, False):
        want = RS.ga_search(gr, mr, seed=1,
                            params=RS.GAParams(device=device, **GA_KW),
                            releases=relr, frozen=fr)
        got = TS.ga_search(gt, mt, seed=1,
                           params=TS.GAParams(device=device, backend="torch",
                                              **GA_KW),
                           releases=relt, frozen=ft)
        runs.append((want, got))
    (want_dev, got_dev), (want_host, got_host) = runs
    assert np.array_equal(want_dev[0], want_host[0]) \
        and want_dev[1] == want_host[1]
    assert np.array_equal(got_dev[0], got_host[0]) \
        and got_dev[1] == got_host[1]
    np.testing.assert_allclose(got_dev[1], want_dev[1], rtol=RTOL_F32,
                               atol=0.0)
    # the port's float64 host search is the reference's, bit for bit
    got_f64 = TS.ga_search(gt, mt, seed=1,
                           params=TS.GAParams(backend="numpy", **GA_KW),
                           releases=relt, frozen=ft)
    assert np.array_equal(got_f64[0], want_dev[0]) \
        and got_f64[1] == want_dev[1]


def online_pair(n_apps=6, seed=2):
    out = []
    for pkg, core in ((RO, R), (TO, T)):
        eng = pkg.OnlineAMTHA(core.cluster_of_multicores(n_blades=1))
        params = pkg.ArrivalParams(rate=0.9 * 8 / 550, process="bursty")
        for a in pkg.generate_workload(params, n_apps=n_apps, seed=seed):
            eng.admit(a)
        out.append(eng)
    return out


@pytest.mark.parametrize("mid_flight", [False, True])
def test_refine_ga_equals_reference(mid_flight):
    er, et = online_pair()
    if mid_flight:
        for eng in (er, et):
            eng.state.advance_to(0.5 * (eng.state.now
                                        + eng.state.schedule.makespan()))
    want = er.refine_ga(seed=3, params=RS.GAParams(**GA_KW))
    got = et.refine_ga(seed=3, params=TS.GAParams(backend="numpy", **GA_KW))
    assert got == want
    assert placements(et.state.schedule) == placements(er.state.schedule)
    assert et.state.task_coherent == er.state.task_coherent
    assert [a.t_est_finish for a in et.state.apps] \
        == [a.t_est_finish for a in er.state.apps]
    et.state.validate()


def test_default_fitness_runs_on_the_card(monkeypatch):
    """``GAParams()`` and ``refine_ga``'s defaults take the kernel
    backend, which refuses to run without a CUDA device."""
    assert TS.GAParams().backend == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (gt, mt) = pair("8core", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ga_search(gt, mt, params=TS.GAParams(**GA_KW))
    _, et = online_pair(n_apps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.refine_ga()


@pytest.mark.parametrize("bad", [dict(backend="pallas"), dict(pop_size=0),
                                 dict(elite=9, pop_size=8),
                                 dict(elite_bias=1.5)])
def test_gaparams_validated_on_construction(bad):
    with pytest.raises(ValueError):
        TS.GAParams(**bad)
