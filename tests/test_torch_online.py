"""The port's online slice against the JAX package on the CPU: the
``sched_score`` kernel's plain version, the new lowering helpers, the
arrival and fault-script generators, every admission policy, the service
metrics and fault recovery, on the same NumPy-seeded inputs.

Tolerances: every comparison here is exact. The host paths run the same
float64 expressions in the same order, and the scoring matrix is one
float32 max and one float32 add, so placements, metrics, recovery
reports and scores are compared with ``==`` and arrays bit for bit
(``np.array_equal``, or their raw float32 bits where both sides are
NumPy or PyTorch on this CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.machine as RM
import repro.faults as RF
import repro.online as RO
import repro_torch.core as T
import repro_torch.core.machine as TM
import repro_torch.faults as TF
import repro_torch.online as TO
from repro.kernels.sched_ref import sched_score_np as ref_sched_score_np
from repro.kernels.sched_score import sched_score as ref_sched_score
from repro.search.ga import GAParams as RGAParams
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sched_score_np
from repro_torch.kernels.sched_score import sched_score_torch
from repro_torch.search.ga import GAParams as TGAParams


def bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def placements(sch):
    return {sid: (p.core, p.start, p.end) for sid, p in sch.placements.items()}


def score_inputs(seed, a, c, special=True):
    """Drains, frontiers and releases in the ranges the policy produces,
    with ``±inf`` and exact ties between frontiers and releases mixed in."""
    rng = np.random.default_rng(seed)
    drain = rng.uniform(0.0, 500.0, (a, c)).astype(np.float32)
    f = rng.uniform(0.0, 1000.0, c).astype(np.float32)
    r = rng.uniform(0.0, 1000.0, a).astype(np.float32)
    if special:
        f[rng.random(c) < 0.2] = np.inf
        r[rng.random(a) < 0.2] = -np.inf
        drain[rng.random((a, c)) < 0.05] = -np.inf
        drain[rng.random((a, c)) < 0.05] = np.inf
        f[: min(a, c)] = np.where(rng.random(min(a, c)) < 0.5,
                                  r[: min(a, c)], f[: min(a, c)])
    return drain, f, r


def plain(drain, f, r):
    return sched_score_torch(torch.from_numpy(drain), torch.from_numpy(f),
                             torch.from_numpy(r)).numpy()


# ---------------------------------------------------------------------------
# the sched_score kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,c", [(1, 1), (1, 300), (16, 1), (16, 256),
                                 (130, 129), (7, 1000)])
def test_plain_score_equals_reference_kernel_and_oracle(a, c):
    drain, f, r = score_inputs(a * 1000 + c, a, c)
    got = plain(drain, f, r)
    want = ref_sched_score_np(drain, f, r)
    assert got.shape == want.shape == (a, c)
    assert np.array_equal(bits(got), bits(want))          # NaN bits too
    assert np.array_equal(bits(got), bits(sched_score_np(drain, f, r)))
    pallas = np.asarray(ref_sched_score(drain, f, r, interpret=True))
    assert np.array_equal(got, pallas, equal_nan=True)


def test_plain_score_keeps_subnormal_drains_and_numpy_max_rule():
    """Subnormal drains survive the add, and the max picks NumPy's
    operand on ties of signed zeros and propagates NaN from either side.
    Held against the NumPy oracle only: the reference's Pallas kernel in
    interpret mode runs on XLA:CPU, which flushes subnormals to zero."""
    tiny = np.float32(1e-40)                          # subnormal float32
    f = np.array([0.0, -0.0, np.nan, 1.0, 0.0], np.float32)
    r = np.array([-0.0, 0.0, 1.0, np.nan, 0.0], np.float32)
    drain = np.full((5, 5), tiny, np.float32)
    drain[0, 0] = drain[1, 1] = -0.0
    got = plain(drain, f, r)
    assert np.array_equal(bits(got), bits(ref_sched_score_np(drain, f, r)))
    assert got[4, 4] == tiny and bits(got)[0, 0] != bits(got)[1, 1]
    assert np.isnan(got[:, 2]).all() and np.isnan(got[3, :]).all()


def test_ops_sched_score_guard_and_cpu_launch_count():
    drain, f, r = (torch.from_numpy(x)
                   for x in score_inputs(1, 4, 6, special=False))
    before = ops.sched_score.launches
    out = ops.sched_score(drain, f, r)
    assert torch.equal(out, sched_score_torch(drain, f, r))
    assert ops.sched_score.launches == before       # the CPU launches nothing
    with pytest.raises(TypeError, match="dtype"):
        ops.sched_score(drain.double(), f, r)
    with pytest.raises(TypeError, match="torch.Tensor"):
        ops.sched_score(drain.numpy(), f, r)
    with pytest.raises(ValueError, match="shape"):
        ops.sched_score(drain, f[:-1], r)
    with pytest.raises(ValueError, match="shape"):
        ops.sched_score(drain, f, torch.cat([r, r]))
    with pytest.raises(ValueError, match=r"\(A, C\)"):
        ops.sched_score(drain[0].contiguous(), f, r[:1])
    with pytest.raises(ValueError, match="contiguous"):
        ops.sched_score(drain.t(), r, f)
    with pytest.raises(ValueError, match="several devices"):
        ops.sched_score(drain, f.to("meta"), r)
    for a, c in [(0, 6), (4, 0)]:
        empty = ops.sched_score(torch.zeros(a, c), torch.zeros(c),
                                torch.zeros(a))
        assert empty.shape == (a, c)
    assert ops.sched_score.launches == before


# ---------------------------------------------------------------------------
# lowering helpers, arrivals, fault scripts
# ---------------------------------------------------------------------------

def test_drain_population_and_repeat_batch_equal_reference():
    mr, mt = R.cluster_of_multicores(n_blades=2, n_types=2), \
        T.cluster_of_multicores(n_blades=2, n_types=2)
    sp = dict(n_tasks=(6, 12), n_types=2)
    gr = [R.generate_app(R.SynthParams(**sp), seed=40 + i) for i in range(3)]
    gt = [T.generate_app(T.SynthParams(**sp), seed=40 + i) for i in range(3)]
    assert np.array_equal(R.drain_matrix(gr, mr), T.drain_matrix(gt, mt))
    rel = {0: 3.5, 4: 1.25}
    sr = [R.get_scheduler(n)(gr[0], mr) for n in ("engine", "heft", "etf")]
    st = [T.get_scheduler(n)(gt[0], mt) for n in ("engine", "heft", "etf")]
    br = R.lower_population(gr[0], mr, sr, releases=rel)
    bt = T.lower_population(gt[0], mt, st, releases=rel)
    script_r = RF.random_script(16, seed=2, horizon=50.0)
    script_t = TF.random_script(16, seed=2, horizon=50.0)
    faulty_r = R.batch_scenarios([R.lower_scenario(
        gr[1], mr, R.engine_schedule(gr[1], mr), faults=script_r)])
    faulty_t = T.batch_scenarios([T.lower_scenario(
        gt[1], mt, T.engine_schedule(gt[1], mt), faults=script_t)])
    for a, b in [(br, bt), (R.repeat_batch(br, 3), T.repeat_batch(bt, 3)),
                 (R.repeat_batch(faulty_r, 2), T.repeat_batch(faulty_t, 2)),
                 (R.repeat_batch(br, 1), T.repeat_batch(bt, 1))]:
        fields = [f.name for f in dataclasses.fields(a)]
        assert fields == [f.name for f in dataclasses.fields(b)]
        for name in fields:
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y, equal_nan=True), name
            else:
                assert x == y, name


def arrival_state(a):
    g = a.graph
    g.finalize()
    return (a.app_id, a.t_arrival, a.deadline, a.size_class, a.criticality,
            [s.times for s in g.subtasks],
            [(e.src, e.dst, e.volume) for e in g.edges])


@pytest.mark.parametrize("process", ["poisson", "bursty"])
def test_workload_and_fault_script_streams_identical(process):
    kw = dict(rate=0.05, process=process, p_large=0.3, n_types=2,
              criticality_weights=(0.5, 0.3, 0.2))
    for seed in (0, 11):
        wr = RO.generate_workload(RO.ArrivalParams(**kw), n_apps=8, seed=seed)
        wt = TO.generate_workload(TO.ArrivalParams(**kw), n_apps=8, seed=seed)
        assert [arrival_state(a) for a in wr] == [arrival_state(a) for a in wt]
        skw = dict(seed=seed, horizon=300.0, n_fail=2, n_slow=2, n_degrade=2,
                   protect=(0,), t_window=(0.2, 0.4))
        sr, st = RF.random_script(16, **skw), TF.random_script(16, **skw)
        assert [dataclasses.astuple(e) for e in sr.events] \
            == [dataclasses.astuple(e) for e in st.events]
        assert st.fail_times(16) == sr.fail_times(16)
        assert st.slow_events(16) == sr.slow_events(16)
        assert st.degrade_events() == sr.degrade_events()


# ---------------------------------------------------------------------------
# admission policies, metrics, compaction
# ---------------------------------------------------------------------------

def cluster(pkg):
    """16 cores in two blades of two processor types."""
    core = R if pkg is RO else T
    return core.cluster_of_multicores(n_blades=2, n_types=2)


def workload(pkg, n_apps=12, seed=5):
    params = pkg.ArrivalParams(rate=0.9 * 16 / 550, process="bursty",
                               n_types=2, criticality_weights=(0.6, 0.4))
    return pkg.generate_workload(params, n_apps=n_apps, seed=seed)


POLICIES = [("fifo", {}), ("rank", {"k": 3}), ("batched", {"k": 4}),
            ("batched", {"k": 4, "scorer": "kernel"}),
            ("critical", {"k": 3})]


def run_policy(pkg, name, kw):
    if pkg is TO and kw.get("scorer") == "kernel":
        kw = dict(kw, device="cpu")
    return pkg.make_policy(name, **kw).run(cluster(pkg), workload(pkg))


@pytest.mark.parametrize("name,kw", POLICIES,
                         ids=[f"{n}-{k.get('scorer', '')}" for n, k in POLICIES])
def test_policy_placements_and_metrics_equal_reference(name, kw):
    sr, st = run_policy(RO, name, kw), run_policy(TO, name, kw)
    assert placements(st.schedule) == placements(sr.schedule)
    assert [(a.app_id, a.sid_offset, a.t_admit, a.t_est_finish)
            for a in st.apps] == [(a.app_id, a.sid_offset, a.t_admit,
                                   a.t_est_finish) for a in sr.apps]
    st.validate()
    for contention in (False, True):
        assert TO.evaluate(st, contention=contention).row() \
            == RO.evaluate(sr, contention=contention).row()
    ms = sr.schedule.makespan()
    fr = RF.random_script(16, seed=4, horizon=ms, protect=(0,))
    ft = TF.random_script(16, seed=4, horizon=ms, protect=(0,))
    assert TO.evaluate(st, faults=ft).row() == RO.evaluate(sr, faults=fr).row()
    assert TO.evaluate(st, simulator="events", jitter=0.05, seed=3).row() \
        == RO.evaluate(sr, simulator="events", jitter=0.05, seed=3).row()


def test_kernel_policy_defaults_to_the_card():
    pol = TO.make_policy("batched", k=4, scorer="kernel")
    assert pol.device == torch.device("cuda") and pol.scorer == "kernel"
    assert TO.BatchedPolicy().scorer == "exact"


def test_kernel_scores_equal_reference():
    wr, wt = workload(RO), workload(TO)
    er, et = RO.OnlineAMTHA(cluster(RO)), TO.OnlineAMTHA(cluster(TO))
    for a in wr[:5]:
        er.admit(a)
    for a in wt[:5]:
        et.admit(a)
    now = wr[8].t_arrival
    pol = TO.BatchedPolicy(k=7, scorer="kernel", device="cpu")
    got = pol.kernel_scores(wt[5:12], et, now)
    want = RO.BatchedPolicy.kernel_scores(wr[5:12], er, now)
    assert got == want
    assert [a.app_id for a in pol.order_batch(wt[5:12], et, now)] \
        == [a.app_id for a in RO.BatchedPolicy(k=7, scorer="kernel")
            .order_batch(wr[5:12], er, now)]


def test_replay_fifo_and_compact_equal_reference():
    sr = RO.replay_fifo(cluster(RO), workload(RO, n_apps=16))
    st = TO.replay_fifo(cluster(TO), workload(TO, n_apps=16),
                        validate_each=True)
    assert placements(st.schedule) == placements(sr.schedule)
    for state in (sr, st):
        state.advance_to(0.5 * (state.now + state.schedule.makespan()))
    assert st.compact() == sr.compact() > 0
    assert placements(st.schedule) == placements(sr.schedule)
    assert (st.retired_busy, st.n_retired, st.retired_by_tier,
            st.retired_est_miss_by_tier) == (sr.retired_busy, sr.n_retired,
                                             sr.retired_by_tier,
                                             sr.retired_est_miss_by_tier)
    assert st.utilization() == sr.utilization()
    st.validate()
    assert TO.evaluate(st).row() == RO.evaluate(sr).row()


# ---------------------------------------------------------------------------
# fault recovery
# ---------------------------------------------------------------------------

def loaded(pkg, n_apps=10, seed=7):
    eng = pkg.OnlineAMTHA(cluster(pkg))
    for a in workload(pkg, n_apps=n_apps, seed=seed):
        eng.admit(a)
    return eng


def report_tuple(rep):
    return dataclasses.astuple(rep)


@pytest.mark.parametrize("ga", [False, True])
@pytest.mark.parametrize("fseed", [1, 2])
def test_recover_from_script_equals_reference(fseed, ga):
    er, et = loaded(RO), loaded(TO)
    ms = er.state.schedule.makespan()
    kw = dict(seed=fseed, horizon=ms, n_fail=1, n_slow=1, n_degrade=1,
              protect=(0,), t_window=(0.2, 0.4))
    sr, st = RF.random_script(16, **kw), TF.random_script(16, **kw)
    gkw = dict(pop_size=6, generations=2, refine_rounds=1, refine_moves=8)
    pr = RO.RecoveryParams(ga_refine=ga, ga_params=RGAParams(**gkw))
    pt = TO.RecoveryParams(ga_refine=ga,
                           ga_params=TGAParams(backend="numpy", **gkw))
    rep_r = RO.recover_from_script(er, sr, 0.5 * ms, pr)
    rep_t = TO.recover_from_script(et, st, 0.5 * ms, pt)
    assert report_tuple(rep_t) == report_tuple(rep_r)
    assert rep_t.n_rolled_back > 0
    assert placements(et.state.schedule) == placements(er.state.schedule)
    assert et.state.task_coherent == er.state.task_coherent
    et.state.validate()
    assert TO.evaluate(et.state, faults=st).row() \
        == RO.evaluate(er.state, faults=sr).row()


def test_detect_progress_equals_reference():
    er, et = loaded(RO), loaded(TO)
    ms = er.state.schedule.makespan()
    sr = RF.FaultScript((RF.core_fail(0.3 * ms, 5),
                         RF.core_slow(0.1 * ms, 2, 3.0)))
    st = TF.FaultScript((TF.core_fail(0.3 * ms, 5),
                         TF.core_slow(0.1 * ms, 2, 3.0)))
    simr = R.simulate(er.state.merged_graph(), er.machine, er.state.schedule,
                      contention=False, faults=sr)
    simt = T.simulate(et.state.merged_graph(), et.machine, et.state.schedule,
                      contention=False, faults=st)
    assert simt.subtask_end == simr.subtask_end
    dr = RO.detect_progress(er.state, simr.subtask_end, 0.6 * ms)
    dt = TO.detect_progress(et.state, simt.subtask_end, 0.6 * ms)
    assert (dt.at, dt.dead, dt.slow, dt.fail_t) \
        == (dr.at, dr.dead, dr.slow, dr.fail_t)
    assert report_tuple(TO.recover(et, dt)) == report_tuple(RO.recover(er, dr))
    assert placements(et.state.schedule) == placements(er.state.schedule)


def quad(machine_module):
    """The 4-core machine of the reference's fault tests."""
    return machine_module.MachineModel(
        "quad", core_types=[0, 0, 1, 1],
        locations=[(0, 0), (0, 1), (1, 0), (1, 1)],
        levels=[machine_module.CommLevel("bus", 1e-4, 1e9),
                machine_module.CommLevel("l2", 1e-6, 1e10)])


def test_reference_recovery_fault_is_shared():
    """The falsifying example ``seed=0, fseed=0, frac=0.25`` of the
    reference's ``test_recovery_validity_property``: after recovery a
    placement still ends past its core's fail instant. The port copies
    the reference's semantics, so both packages place identically and
    share the fault (a known fault, left for a later fix in both)."""
    out = []
    for pkg, fpkg in ((RO, RF), (TO, TF)):
        eng = pkg.OnlineAMTHA(quad(RM if pkg is RO else TM))
        for a in pkg.generate_workload(
                pkg.ArrivalParams(n_types=2,
                                  criticality_weights=(0.5, 0.3, 0.2)),
                n_apps=5, seed=0):
            eng.admit(a)
        ms = eng.state.schedule.makespan()
        script = fpkg.random_script(4, seed=0, horizon=ms, n_fail=1,
                                    n_slow=1, n_degrade=0, protect=(0,))
        pkg.recover_from_script(eng, script, ms * 0.25)
        eng.state.validate()
        fail_t = script.fail_times(4)
        late = sorted(sid for sid, p in eng.state.schedule.placements.items()
                      if p.end > fail_t[p.core] + 1e-9)
        out.append((placements(eng.state.schedule), late))
    assert out[1] == out[0]
    assert out[0][1], "the reference's recovery fault is gone: update " \
                      "ROADMAP §C and this test"
