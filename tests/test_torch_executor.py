"""The port's threaded executor (the paper's measured T_exec) against
the JAX package's.

T_exec is wall-clock time, so it is held to invariants only, never to a
value: it is never below the schedule's T_est, nor below the
jitter-free simulated makespan of the same scenario, nor, on one core,
below the sum of the chain's durations; T_exec is ``wall_seconds``
scaled back to model seconds. The reference's executor on the same
schedule satisfies the same invariants. ``dif_rel`` (the paper's Eq. 4)
is a formula and is held exactly.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core.convert import graph_from, machine_from, schedule_from

SCALE = 1e-4                     # model seconds -> wall seconds


def suite(pkg, n_apps=3):
    m = pkg.dell_poweredge_1950()
    graphs = pkg.paper_suite_8core(n_apps=n_apps, seed=0)
    return m, graphs, [pkg.engine_schedule(g, m) for g in graphs]


def assert_invariants(res, t_est, t_sim):
    assert res.t_exec >= t_est
    assert res.t_exec >= t_sim
    assert res.t_exec == res.wall_seconds / SCALE
    assert res.dif_rel(t_est) == (res.t_exec - t_est) / res.t_exec * 100.0
    assert res.dif_rel(t_est) >= 0.0


@pytest.mark.parametrize("t_exec,t_est", [(120.0, 100.0), (100.0, 100.0),
                                          (87.5, 100.0), (1e-3, 3e-4),
                                          (283.4524, 150.52235327)])
def test_dif_rel_equals_the_reference(t_exec, t_est):
    got = T.ExecResult(t_exec=t_exec, wall_seconds=t_exec * SCALE)
    want = R.ExecResult(t_exec=t_exec, wall_seconds=t_exec * SCALE)
    assert got.dif_rel(t_est) == want.dif_rel(t_est)
    assert got.dif_rel(t_est) == (t_exec - t_est) / t_exec * 100.0


@pytest.mark.parametrize("n_apps", [2, 3])
def test_threaded_t_exec_never_beats_the_schedule(n_apps):
    """On a 2-3-app 8-core paper suite, both packages' executors give a
    T_exec at or above T_est and above the CPU backend's jitter-free
    ``simulate_batch`` makespan of the same scenario (which equals
    T_est: the analytic simulator reproduces the schedule)."""
    mt, gt, st = suite(T, n_apps)
    mr, gr, sr = suite(R, n_apps)
    sim = T.simulate_suite(gt, mt, st, jitter=0.0, backend="numpy")
    np.testing.assert_array_equal(sim.t_est, [s.makespan() for s in st])
    for i, (g, s) in enumerate(zip(gt, st)):
        assert s.makespan() == sr[i].makespan()
        res = T.execute_threaded(g, mt, s, time_scale=SCALE)
        assert isinstance(res, T.ExecResult)
        assert_invariants(res, s.makespan(), float(sim.t_exec[i]))
        ref = R.execute_threaded(gr[i], mr, sr[i], time_scale=SCALE)
        assert_invariants(ref, sr[i].makespan(), float(sim.t_exec[i]))


def test_one_core_chain_takes_at_least_its_durations():
    """A chain of tasks on a single core: T_exec is at least the sum of
    its subtasks' durations on that core's type."""
    m = T.dell_poweredge_1950()
    g = T.generate_app(T.SynthParams(n_tasks=(6, 6)), seed=3)
    g.finalize()
    sch = T.Schedule(m.n_cores)
    t = 0.0
    pending = list(range(g.n_subtasks))
    while pending:              # back to back, in a topological order
        sid = next(s for s in pending
                   if all(p in sch.placements for p, _ in g.preds[s]))
        dur = g.subtasks[sid].time_on(m.core_types[0])
        sch.place(sid, 0, t, t + dur)
        t += dur
        pending.remove(sid)
    T.validate(sch, g, m)
    total = sum(st.time_on(m.core_types[0]) for st in g.subtasks)
    res = T.execute_threaded(g, m, sch, time_scale=SCALE)
    assert res.t_exec >= total
    assert res.t_exec >= sch.makespan()


def test_reference_objects_run_through_the_converters():
    """A graph, machine and schedule of the reference package run as
    they are (converted by ``core/convert.py``), give the invariants,
    and are left as they were."""
    mr, gr, sr = suite(R, 2)
    g, s = gr[0], sr[0]
    before = (len(g.subtasks), dict(s.placements))
    res = T.execute_threaded(g, mr, s, time_scale=SCALE)
    assert isinstance(res, T.ExecResult)
    assert (len(g.subtasks), dict(s.placements)) == before
    sim = T.simulate_suite([graph_from(g)], machine_from(mr),
                           [schedule_from(s)], jitter=0.0, backend="numpy")
    assert_invariants(res, s.makespan(), float(sim.t_exec[0]))
