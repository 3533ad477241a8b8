"""The port's host layer against the JAX package: the same synthetic
graphs from the same seeds, the same placements from every registered
mapper, the same lowered arrays, and the converters that carry a
reference-built graph, machine and schedule across."""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import graph_from, machine_from, schedule_from


def placements(sch):
    return {sid: (p.core, p.start, p.end) for sid, p in sch.placements.items()}


def graph_state(g):
    g.finalize()
    return ([(s.sid, s.task_id, s.index_in_task, s.times) for s in g.subtasks],
            dict(g.tasks), [(e.src, e.dst, e.volume) for e in g.edges],
            g.preds, g.succs)


SUITES = {
    "8core": (lambda pkg: pkg.dell_poweredge_1950(),
              lambda pkg: pkg.paper_suite_8core(n_apps=3, seed=4)),
    "64core": (lambda pkg: pkg.hp_bl260c(),
               lambda pkg: [pkg.generate_app(pkg.SynthParams(n_tasks=(10, 20)),
                                             seed=100 + i) for i in range(2)]),
    "hetero": (lambda pkg: pkg.heterogeneous_cluster(),
               lambda pkg: pkg.paper_suite_8core(n_apps=2, seed=9, n_types=2)),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_synth_graphs_identical(suite):
    _, make = SUITES[suite]
    for gr, gt in zip(make(R), make(T)):
        assert graph_state(gr) == graph_state(gt)


@pytest.mark.parametrize("name", ["amtha", "engine", "heft", "etf"])
@pytest.mark.parametrize("suite", sorted(SUITES))
def test_registered_mappers_place_identically(suite, name):
    machine, make = SUITES[suite]
    mr, mt = machine(R), machine(T)
    for gr, gt in zip(make(R), make(T)):
        sr = R.get_scheduler(name)(gr, mr)
        st = T.get_scheduler(name)(gt, mt)
        assert placements(sr) == placements(st)
        assert sr.makespan() == st.makespan()
        T.validate(st, gt, mt,
                   require_task_coherence=T.scheduler_entry(name).task_coherent)


def test_registry_names():
    assert sorted(T.SCHEDULERS) == ["amtha", "engine", "etf", "ga", "heft"]
    assert sorted(T.SIMULATORS) == ["arrays", "events"]
    with pytest.raises(ValueError, match="unknown scheduler"):
        T.get_scheduler("nope")
    with pytest.raises(ValueError, match="unknown simulator"):
        T.get_simulator("nope")


def _assert_same_fields(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_lowering_and_batching_give_identical_arrays(suite):
    machine, make = SUITES[suite]
    mr, mt = machine(R), machine(T)
    scen_r, scen_t = [], []
    for gr, gt in zip(make(R), make(T)):
        sr, st = R.engine_schedule(gr, mr), T.engine_schedule(gt, mt)
        rel = {0: 1.5, 3: 0.25}
        a = R.lower_scenario(gr, mr, sr, releases=rel)
        b = T.lower_scenario(gt, mt, st, releases=rel)
        _assert_same_fields(a.machine, b.machine,
                            ["n_cores", "n_types", "core_types", "lat", "bw",
                             "pair_instance", "inst_level", "inst_lat",
                             "inst_bw"])
        _assert_same_fields(a.graph, b.graph,
                            ["n_subtasks", "n_tasks", "n_types", "exec_type",
                             "task_of", "pred_ptr", "pred_sid", "pred_vol",
                             "succ_ptr", "succ_sid", "succ_vol"])
        _assert_same_fields(a, b, ["exec_core", "core_of", "start", "end",
                                   "order_ptr", "order_sid", "release",
                                   "release_order"])
        scen_r.append(a)
        scen_t.append(b)
    br, bt = R.batch_scenarios(scen_r), T.batch_scenarios(scen_t)
    _assert_same_fields(br, bt, ["n_scenarios", "max_subtasks", "max_preds",
                                 "n_sub", "duration", "release", "prev",
                                 "pred", "pred_lat", "pred_volbw", "wave",
                                 "t_est", "depth"])
    assert not bt.has_faults


def test_convert_carries_reference_state_across():
    """A graph, machine and schedule built by the JAX package convert to
    the port's types field for field, convert again to themselves, and
    lower to the same arrays as the port's own."""
    mr = R.heterogeneous_cluster()
    gr = R.generate_app(R.SynthParams(n_tasks=(8, 12), n_types=2), seed=5)
    sr = R.engine_schedule(gr, mr)          # a Timeline
    g, m, s = graph_from(gr), machine_from(mr), schedule_from(sr)
    assert isinstance(g, T.AppGraph) and isinstance(m, T.MachineModel)
    assert isinstance(s, T.Schedule)
    assert graph_state(g) == graph_state(gr)
    assert (m.name, m.core_types, m.locations, m.n_types) == \
        (mr.name, mr.core_types, mr.locations, mr.n_types)
    assert [(lv.name, lv.latency, lv.bandwidth) for lv in m.levels] == \
        [(lv.name, lv.latency, lv.bandwidth) for lv in mr.levels]
    assert placements(s) == placements(sr)
    assert [s.order_on_core(c) for c in range(m.n_cores)] == \
        [sr.order_on_core(c) for c in range(mr.n_cores)]
    T.validate(s, g, m)
    # converting the port's own objects is the identity
    assert graph_state(graph_from(g)) == graph_state(g)
    assert placements(schedule_from(s)) == placements(s)
    assert machine_from(m) == m
    # a reference schedule simulates on the port like the port's own
    own = T.engine_schedule(T.generate_app(
        T.SynthParams(n_tasks=(8, 12), n_types=2), seed=5),
        T.heterogeneous_cluster())
    assert placements(own) == placements(s)
    assert T.simulate(g, m, s, contention=True).subtask_end == \
        R.simulate(gr, mr, sr, contention=True).subtask_end


def test_convert_reads_a_plain_reference_schedule():
    mr = R.dell_poweredge_1950()
    gr = R.generate_app(R.SynthParams(n_tasks=(6, 9)), seed=2)
    sr = R.amtha_schedule(gr, mr)           # a Schedule
    s = schedule_from(sr)
    assert placements(s) == placements(sr)
    assert s.core_slots == sr.core_slots
