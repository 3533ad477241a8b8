"""The port's analysis layer (``repro_torch.analysis``) against the JAX
package's on the CPU: every corruption of ``tests/test_analysis.py``,
made the same way in both packages, raises in both with the same
``Violation`` kinds (the verifier) or the same message (the IR lint);
then the ``verify=`` flags of the registry, ``simulate_batch`` /
``simulate_suite``, ``OnlineAMTHA`` and ``RecoveryParams``, and the
``python -m repro_torch.analysis.verify`` sweep.

Every check is exact: the verifier is copied expression for expression
and runs on the same schedules, so both packages must name the same
violations.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.analysis as RA
import repro.core as R
import repro.core.machine as RM
import repro.faults as RF
import repro.online as RO
import repro_torch.analysis as TA
import repro_torch.core as T
import repro_torch.core.machine as TM
import repro_torch.faults as TF
import repro_torch.online as TO
from repro.core import lowering as RL
from repro.core.mpaha import AppGraph as RGraph
from repro.core.schedule import Placement as RPlacement
from repro_torch.analysis import verify as verify_module
from repro_torch.core import lowering as TL
from repro_torch.core.mpaha import AppGraph as TGraph
from repro_torch.core.schedule import Placement as TPlacement
from repro_torch.search import GAParams

VOL = 3e9       # ~1 s cross-socket on the Dell model: comm lag >> tolerances

PKGS = {
    "ref": SimpleNamespace(core=R, an=RA, low=RL, online=RO, faults=RF,
                           AppGraph=RGraph, Placement=RPlacement),
    "port": SimpleNamespace(core=T, an=TA, low=TL, online=TO, faults=TF,
                            AppGraph=TGraph, Placement=TPlacement),
}


def two_task_graph(ns):
    """sid 0 (10 s) --VOL--> sid 1 (5 s): one comm edge, no chains."""
    g = ns.AppGraph(n_types=1)
    g.add_task(0, [(10.0,)])
    g.add_task(1, [(5.0,)])
    g.add_edge(0, 1, volume=VOL)
    g.finalize()
    return g


def tight_schedule(ns, g, m):
    """The tightest valid plan: consumer starts exactly at end + comm."""
    comm = m.comm_time(VOL, 0, 7)
    s = ns.core.Schedule(m.n_cores)
    s.place(0, 0, 0.0, 10.0)
    s.place(1, 7, 10.0 + comm, 15.0 + comm)
    return s


def rebuilt(ns, base, override=None, extra=None, skip=()):
    """Copy a schedule with one targeted edit (keeps core_slots sorted)."""
    out = ns.core.Schedule(base.n_cores)
    for sid, p in base.placements.items():
        if sid in skip:
            continue
        core, start, end = (override or {}).get(sid, (p.core, p.start, p.end))
        out.place(sid, core, start, end)
    for sid, core, start, end in (extra or ()):
        out.place(sid, core, start, end)
    return out


def kinds_of(ns, fn):
    with pytest.raises(ns.an.VerifyError) as ei:
        fn()
    assert isinstance(ei.value, ns.core.ScheduleError)
    return ei.value.kinds


# ---------------------------------------------------------------------------
# verifier corruptions, one invariant at a time, named alike in both
# ---------------------------------------------------------------------------

def _schedule_case(ns, edit):
    g, m = two_task_graph(ns), ns.core.dell_poweredge_1950()
    comm = m.comm_time(VOL, 0, 7)
    sch = tight_schedule(ns, g, m)
    kw = {}
    if edit == "comm":          # precedence holds, comm dropped
        sch = rebuilt(ns, sch, override={1: (7, 10.0, 15.0)})
    elif edit == "precedence":
        sch = rebuilt(ns, sch, override={1: (7, 4.0, 9.0)})
    elif edit == "overlap":     # onto the producer's core, mid-interval
        sch = rebuilt(ns, sch, override={1: (0, 5.0, 10.0)})
    elif edit == "stale-extra":
        sch = rebuilt(ns, sch, extra=[(99, 2, 0.0, 1.0)])
    elif edit == "missing":
        sch = rebuilt(ns, sch, skip=(1,))
    elif edit == "duration":
        sch = rebuilt(ns, sch, override={1: (7, 10.0 + comm, 12.0 + comm)})
    elif edit == "core-range":
        sch.placements[1].core = 42
    elif edit == "release-floor":
        kw = {"release_floor": 1.0}
    elif edit == "release-map":
        kw = {"releases": {0: 2.5}}
    elif edit == "collect-two":
        sch = rebuilt(ns, sch, override={1: (7, 4.0, 9.0)},
                      extra=[(99, 2, 0.0, 1.0)])
    elif edit == "sid-offset":
        kw = {"sid_offset": 10}
    return lambda: ns.an.verify_schedule(sch, g, m, **kw)


def _task_split_case(ns):
    m = ns.core.dell_poweredge_1950()
    g = ns.AppGraph(n_types=1)
    g.add_task(0, [(3.0,), (4.0,)])     # one task, chained subtasks
    g.finalize()
    comm = m.comm_time(0.0, 0, 1)
    s = ns.core.Schedule(m.n_cores)
    s.place(0, 0, 0.0, 3.0)
    s.place(1, 1, 3.0 + comm, 7.0 + comm)
    assert ns.an.verify_schedule(s, g, m, require_task_coherence=False,
                                 collect=True) == []
    return lambda: ns.an.verify_schedule(s, g, m)


def _timeline_case(ns, edit):
    tl = ns.core.Timeline(2)
    tl.place(0, 0, 0.0, 2.0)
    if edit == "open-transaction":
        tl.begin()
    elif edit == "watermark":
        tl._avail[0] = 0.5
    elif edit == "orphan":
        tl.placements[5] = ns.Placement(5, 1, 2.0, 3.0)
    elif edit == "rides-along":
        g, m = two_task_graph(ns), ns.core.dell_poweredge_1950()
        tl = ns.core.Timeline.from_schedule(tight_schedule(ns, g, m))
        assert ns.an.verify_schedule(tl, g, m, collect=True) == []
        tl.begin()
        return lambda: ns.an.verify_schedule(tl, g, m)
    return lambda: ns.an.verify_timeline(tl)


def _sim_result_case(ns, edit):
    m = ns.core.dell_poweredge_1950()
    g = ns.core.generate_app(ns.core.SynthParams(n_tasks=(6, 9)), seed=11)
    sch = ns.core.get_scheduler("engine")(g, m)
    res = ns.core.get_simulator("arrays")(g, m, sch, contention=False)
    assert ns.an.verify_sim_result(res, g, collect=True) == []
    sid = max(res.subtask_end)
    if edit == "makespan":
        res.t_exec += 1.0
    elif edit == "finite-end":
        res.subtask_end[sid] = np.inf
    elif edit == "namespace":
        del res.subtask_end[sid]
    return lambda: ns.an.verify_sim_result(res, g)


def batch_fixture(ns, backend="numpy"):
    m = ns.core.dell_poweredge_1950()
    g = two_task_graph(ns)
    sch = tight_schedule(ns, g, m)
    one = ns.AppGraph(n_types=1)
    one.add_task(0, [(2.0,)])           # 1 subtask -> scenario 1 is padded
    one.finalize()
    s1 = ns.core.Schedule(m.n_cores)
    s1.place(0, 0, 0.0, 2.0)
    batch = ns.low.batch_scenarios([ns.low.lower_scenario(g, m, sch),
                                    ns.low.lower_scenario(one, m, s1)])
    kw = {"backend": backend, "device": "cpu"} if ns.core is T else {}
    res = ns.core.simulate_batch(batch, verify=True, **kw)
    return batch, res


def _batch_case(ns, edit):
    batch, res = batch_fixture(ns)
    end = np.array(res.subtask_end)
    t_exec = np.array(res.t_exec)
    if edit == "comm-lag":
        lag = batch.pred_lat[0, 1, 0] + batch.pred_volbw[0, 1, 0]
        assert lag > 1e-3
        end[0, 1] = end[0, 0] + batch.duration[0, 1] + lag / 2
    elif edit == "precedence":
        end[0, 1] = 12.0                # < end0 + dur = 15
    elif edit == "padding":
        end[1, 1] = 3.14                # scenario 1 has one real subtask
    elif edit == "makespan":
        t_exec = t_exec + 1.0
    elif edit == "nonfinite":
        end[0, 1] = np.inf
    if edit in ("comm-lag", "precedence"):
        t_exec[0] = np.where(np.isfinite(end[0]), end[0], 0.0).max()
    bad = dataclasses.replace(res, subtask_end=end, t_exec=t_exec)
    return lambda: ns.an.verify_batch_result(batch, bad)


VERIFY_CASES = [
    ("schedule-comm", lambda ns: _schedule_case(ns, "comm"), {"comm"}),
    ("schedule-precedence", lambda ns: _schedule_case(ns, "precedence"),
     {"precedence"}),
    ("schedule-overlap", lambda ns: _schedule_case(ns, "overlap"),
     {"overlap"}),
    ("schedule-stale-extra", lambda ns: _schedule_case(ns, "stale-extra"),
     {"namespace"}),
    ("schedule-missing", lambda ns: _schedule_case(ns, "missing"),
     {"namespace"}),
    ("schedule-duration", lambda ns: _schedule_case(ns, "duration"),
     {"duration"}),
    ("schedule-core-range", lambda ns: _schedule_case(ns, "core-range"),
     {"core-range"}),
    ("schedule-release-floor",
     lambda ns: _schedule_case(ns, "release-floor"), {"release"}),
    ("schedule-release-map", lambda ns: _schedule_case(ns, "release-map"),
     {"release"}),
    ("schedule-collect-two", lambda ns: _schedule_case(ns, "collect-two"),
     {"precedence", "namespace"}),
    ("schedule-sid-offset", lambda ns: _schedule_case(ns, "sid-offset"),
     {"namespace"}),
    ("schedule-task-split", _task_split_case, {"task-coherence"}),
    ("timeline-open-transaction",
     lambda ns: _timeline_case(ns, "open-transaction"), {"transaction"}),
    ("timeline-watermark", lambda ns: _timeline_case(ns, "watermark"),
     {"structure"}),
    ("timeline-orphan", lambda ns: _timeline_case(ns, "orphan"),
     {"structure"}),
    ("timeline-rides-along", lambda ns: _timeline_case(ns, "rides-along"),
     {"transaction"}),
    ("sim-makespan", lambda ns: _sim_result_case(ns, "makespan"),
     {"makespan"}),
    ("sim-finite-end", lambda ns: _sim_result_case(ns, "finite-end"),
     {"finite-end"}),
    ("sim-namespace", lambda ns: _sim_result_case(ns, "namespace"),
     {"namespace"}),
    ("batch-comm-lag", lambda ns: _batch_case(ns, "comm-lag"), {"comm"}),
    ("batch-precedence", lambda ns: _batch_case(ns, "precedence"),
     {"precedence"}),
    ("batch-padding", lambda ns: _batch_case(ns, "padding"), {"padding"}),
    ("batch-makespan", lambda ns: _batch_case(ns, "makespan"), {"makespan"}),
    ("batch-nonfinite", lambda ns: _batch_case(ns, "nonfinite"),
     {"finite-end"}),
]


@pytest.mark.parametrize("name,case,expected", VERIFY_CASES,
                         ids=[c[0] for c in VERIFY_CASES])
def test_verifier_names_each_corruption_like_the_reference(name, case,
                                                           expected):
    got = kinds_of(PKGS["port"], case(PKGS["port"]))
    want = kinds_of(PKGS["ref"], case(PKGS["ref"]))
    assert got == want
    assert expected <= got


def test_verifier_collect_reports_every_violation_together():
    ns = PKGS["port"]
    g, m = two_task_graph(ns), T.dell_poweredge_1950()
    bad = rebuilt(ns, tight_schedule(ns, g, m), override={1: (7, 4.0, 9.0)},
                  extra=[(99, 2, 0.0, 1.0)])
    out = TA.verify_schedule(bad, g, m, collect=True)
    assert {v.kind for v in out} == {"precedence", "namespace"}
    assert all(v.kind in TA.KINDS for v in out)
    with pytest.raises(TA.VerifyError) as ei:
        TA.verify_schedule(bad, g, m)
    assert len(ei.value.violations) == len(out)
    assert TA.verify_schedule(tight_schedule(ns, g, m), g, m,
                              collect=True) == []


# ---------------------------------------------------------------------------
# IR lint corruptions
# ---------------------------------------------------------------------------

def _lint_case(ns, edit):
    if edit in ("batch-oob", "batch-wave"):
        batch, _ = batch_fixture(ns)
        if edit == "batch-oob":
            pred = np.array(batch.pred)
            pred[0, 0, 0] = batch.max_subtasks + 3
            bad = dataclasses.replace(batch, pred=pred)
        else:
            bad = dataclasses.replace(batch,
                                      wave=np.zeros_like(batch.wave))
        return lambda: ns.an.lint_batch(bad)
    if edit == "csr-nonmonotone":
        ga = ns.low.graph_arrays(two_task_graph(ns))
        ptr = np.array(ga.pred_ptr)
        ptr[0] = 1
        bad = dataclasses.replace(ga, pred_ptr=ptr)
        return lambda: ns.an.lint_graph_arrays(bad)
    if edit == "csr-cycle":
        ga = ns.low.graph_arrays(two_task_graph(ns))
        it, fl = ga.pred_ptr.dtype, ga.pred_vol.dtype
        bad = dataclasses.replace(
            ga,
            pred_ptr=np.array([0, 1, 2], it), pred_sid=np.array([1, 0], it),
            pred_vol=np.array([1.0, 1.0], fl),
            succ_ptr=np.array([0, 1, 2], it), succ_sid=np.array([1, 0], it),
            succ_vol=np.array([1.0, 1.0], fl))
        return lambda: ns.an.lint_graph_arrays(bad)
    pa = ns.low.population_arrays(two_task_graph(ns),
                                  ns.core.dell_poweredge_1950())
    s = pa.n_subtasks
    pp = np.array(pa.pred_pos)
    i, k = map(int, np.argwhere(pp < s)[0])
    pp[i, k] = i if edit == "population-topo" else s + 2
    bad = dataclasses.replace(pa, pred_pos=pp)
    return lambda: ns.an.lint_population_arrays(bad)


LINT_CASES = [("batch-oob", "gather-bounds"), ("batch-wave", "wave"),
              ("csr-nonmonotone", "pred_ptr"), ("csr-cycle", "cycle"),
              ("population-topo", "pred_pos"),
              ("population-oob", "gather-bounds")]


@pytest.mark.parametrize("edit,match", LINT_CASES,
                         ids=[c[0] for c in LINT_CASES])
def test_ir_lint_names_each_corruption_like_the_reference(edit, match):
    msgs = []
    for ns in (PKGS["port"], PKGS["ref"]):
        with pytest.raises(ns.an.IRLintError, match=match) as ei:
            _lint_case(ns, edit)()
        assert isinstance(ei.value, ValueError)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_lint_ir_accepts_every_lowered_container():
    m = T.dell_poweredge_1950()
    g = T.generate_app(T.SynthParams(n_tasks=(6, 9)), seed=3)
    sch = T.get_scheduler("engine")(g, m)
    sa = TL.lower_scenario(g, m, sch)
    for obj in (TL.machine_arrays(m), TL.graph_arrays(g), sa,
                TL.batch_scenarios([sa]), TL.population_arrays(g, m)):
        TA.lint_ir(obj)
    with pytest.raises(TA.IRLintError, match="no IR lint"):
        TA.lint_ir(object())


# ---------------------------------------------------------------------------
# verify= integration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(T.SCHEDULERS))
def test_every_registered_scheduler_verifies(name):
    m = T.dell_poweredge_1950()
    g = T.generate_app(T.SynthParams(n_tasks=(8, 12)), seed=7)
    kwargs = ({"params": GAParams(pop_size=6, generations=3,
                                  refine_rounds=0, backend="torch")}
              if name == "ga" else {})
    sch = T.get_scheduler(name, verify=True)(g, m, **kwargs)
    assert sch.placements


def test_verifier_passes_on_larger_machines():
    g = T.generate_app(T.SynthParams(n_tasks=(15, 20)), seed=5)
    for m in (T.hp_bl260c(), T.cluster_of_multicores(n_blades=32)):
        sch = T.get_scheduler("engine", verify=True)(g, m)
        assert len(sch.placements) == g.n_subtasks


def test_device_ga_scheduler_verifies():
    m = T.dell_poweredge_1950()
    g = T.generate_app(T.SynthParams(n_tasks=(8, 12)), seed=2)
    par = GAParams(device=True, pop_size=8, generations=3, refine_rounds=1,
                   refine_moves=8, backend="torch")
    assert T.get_scheduler("ga", verify=True)(g, m, params=par).placements


def test_registry_wrappers_reject_broken_entries():
    def drops_first(graph, machine, **kw):
        sch = T.get_scheduler("engine")(graph, machine, **kw)
        return rebuilt(PKGS["port"], sch, skip=(0,))

    def loses_an_end(graph, machine, schedule, *args, **kw):
        res = T.get_simulator("arrays")(graph, machine, schedule, *args, **kw)
        del res.subtask_end[0]
        return res

    T.register_scheduler("_test_bad", drops_first, doc="drops sid 0",
                         overwrite=True)
    T.register_simulator("_test_bad", loses_an_end, doc="loses sid 0",
                         overwrite=True)
    try:
        m = T.dell_poweredge_1950()
        g = T.generate_app(T.SynthParams(n_tasks=(6, 9)), seed=1)
        assert T.get_scheduler("_test_bad")(g, m)     # unverified: passes
        with pytest.raises(TA.VerifyError) as ei:
            T.get_scheduler("_test_bad", verify=True)(g, m)
        assert "namespace" in ei.value.kinds
        sch = T.get_scheduler("engine")(g, m)
        res = T.get_simulator("arrays", verify=True)(g, m, sch,
                                                     contention=False)
        assert res.t_exec > 0
        with pytest.raises(TA.VerifyError) as ei:
            T.get_simulator("_test_bad", verify=True)(g, m, sch,
                                                      contention=False)
        assert "namespace" in ei.value.kinds
    finally:
        T.SCHEDULERS.pop("_test_bad", None)
        T.SIMULATORS.pop("_test_bad", None)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_simulate_batch_verify_lints_and_proves(backend):
    batch, res = batch_fixture(PKGS["port"], backend)
    _, want = batch_fixture(PKGS["ref"])
    np.testing.assert_allclose(res.subtask_end, want.subtask_end, rtol=1e-6)
    pred = np.array(batch.pred)
    pred[0, 0, 0] = batch.max_subtasks + 3
    with pytest.raises(TA.IRLintError, match="gather-bounds"):
        T.simulate_batch(dataclasses.replace(batch, pred=pred), verify=True,
                         backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_simulate_suite_verify_on_suites_and_faults(backend):
    m = T.hp_bl260c()
    graphs = [T.generate_app(T.SynthParams(n_tasks=(20, 30)), seed=10 + i)
              for i in range(2)]
    scheds = [T.engine_schedule(g, m) for g in graphs]
    for jitter in (0.0, 0.05):
        T.simulate_suite(graphs, m, scheds, jitter=jitter, verify=True,
                         backend=backend, device="cpu")
    script = TF.random_script(m.n_cores, seed=1, horizon=max(
        s.makespan() for s in scheds), n_fail=1, n_slow=1, n_degrade=1)
    T.simulate_suite(graphs, m, scheds, faults=[script, None], verify=True,
                     backend=backend, device="cpu")


def test_verify_batch_result_tolerance_follows_the_backend(monkeypatch):
    """float32 sweeps are proven at rtol 1e-5, float64 ones at 1e-9."""
    seen = []
    real = verify_module.verify_batch_result

    def spy(batch, result, **kw):
        seen.append(kw["rtol"])
        return real(batch, result, **kw)

    monkeypatch.setattr(verify_module, "verify_batch_result", spy)
    batch_fixture(PKGS["port"], "torch")
    batch_fixture(PKGS["port"], "numpy")
    assert seen == [1e-5, 1e-9]


def test_cluster_verify_on_admissions_and_corruption():
    kinds = []
    for ns in (PKGS["port"], PKGS["ref"]):
        eng = ns.online.OnlineAMTHA(ns.core.dell_poweredge_1950(),
                                    verify=True)
        for a in ns.online.generate_workload(ns.online.ArrivalParams(),
                                             n_apps=3, seed=4):
            eng.admit(a)                # verify_cluster after each commit
        assert ns.an.verify_cluster(eng.state, collect=True) == []
        eng.state.schedule.remove(max(eng.state.schedule.placements))
        with pytest.raises(ns.an.VerifyError) as ei:
            ns.an.verify_cluster(eng.state)
        kinds.append(ei.value.kinds)
    assert kinds[0] == kinds[1] and "namespace" in kinds[0]


def test_online_verify_rejects_a_corrupted_admission():
    """``OnlineAMTHA(verify=True)`` proves the cluster after the commit,
    so an admission onto a corrupted timeline raises."""
    eng = TO.OnlineAMTHA(T.dell_poweredge_1950(), verify=True)
    wl = TO.generate_workload(TO.ArrivalParams(), n_apps=2, seed=4)
    eng.admit(wl[0])
    eng.state.schedule.remove(max(eng.state.schedule.placements))
    with pytest.raises(TA.VerifyError) as ei:   # an app lost an interval
        eng.admit(wl[1])
    assert "namespace" in ei.value.kinds


def quad(machine_module):
    """The 4-core machine of the reference's fault tests."""
    return machine_module.MachineModel(
        "quad", core_types=[0, 0, 1, 1],
        locations=[(0, 0), (0, 1), (1, 0), (1, 1)],
        levels=[machine_module.CommLevel("bus", 1e-4, 1e9),
                machine_module.CommLevel("l2", 1e-6, 1e10)])


def test_recovery_verify_gives_the_reference_verdict_on_the_shared_fault():
    """The reference's recovery fault (``test_faults.py::
    test_recovery_validity_property`` at seed 0): work left on a dead
    core past its fail instant. ``verify_cluster`` proves schedule
    invariants, not fail instants, so both packages give one verdict."""
    verdicts = []
    for ns in (PKGS["port"], PKGS["ref"]):
        eng = ns.online.OnlineAMTHA(quad(RM if ns.core is R else TM))
        for a in ns.online.generate_workload(
                ns.online.ArrivalParams(n_types=2,
                                        criticality_weights=(0.5, 0.3, 0.2)),
                n_apps=5, seed=0):
            eng.admit(a)
        ms = eng.state.schedule.makespan()
        script = ns.faults.random_script(4, seed=0, horizon=ms, n_fail=1,
                                         n_slow=1, n_degrade=0, protect=(0,))
        try:
            ns.online.recover_from_script(
                eng, script, ms * 0.25,
                ns.online.RecoveryParams(verify=True))
            verdicts.append(("ok", eng.state.schedule.makespan()))
        except ns.an.VerifyError as err:
            verdicts.append(("violations", sorted(err.kinds)))
    assert verdicts[0] == verdicts[1]


def test_recovery_verify_on_a_fault_script():
    eng = TO.OnlineAMTHA(T.dell_poweredge_1950())
    for a in TO.generate_workload(TO.ArrivalParams(), n_apps=4, seed=0):
        eng.admit(a)
    horizon = eng.state.schedule.makespan()
    script = TF.random_script(8, seed=1, horizon=horizon, n_fail=1,
                              n_slow=1, n_degrade=1)
    report = TO.recover_from_script(eng, script, horizon * 0.5,
                                    TO.RecoveryParams(verify=True))
    assert report.new_makespan == eng.state.schedule.makespan()
    TA.verify_cluster(eng.state)


def test_verify_sweep_cli_on_the_cpu(capsys):
    assert verify_module.main(["--quick", "--backend", "torch"]) == 0
    out = capsys.readouterr().out
    assert "ga(device) ok" in out and "recovery ok" in out
    assert out.strip().endswith("0 violations")
