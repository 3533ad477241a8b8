"""The port's slice end to end on the CPU: synthetic suite -> AMTHA ->
lowering -> batched simulation, held against the JAX package.

* ``backend="torch", device="cpu"`` (the kernel's plain version) equals
  the JAX package's ``backend="pallas"`` (its Pallas kernel in interpret
  mode) bit for bit in float32, and the float64 path within the
  reference's float32 tolerance (rtol 1e-5);
* ``backend="numpy"`` equals the JAX package's exactly, with and without
  jitter, and with a fault script routed to the fault path;
* the event loops equal the JAX package's exactly;
* ``backend="cuda"`` raises when it cannot launch the kernel instead of
  running anywhere else.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.faults import random_script
from repro_torch.core.sim_engine import simulate_batch

RTOL_F32 = 1e-5


def suite(pkg, kind):
    if kind == "8core":
        m = pkg.dell_poweredge_1950()
        graphs = pkg.paper_suite_8core(n_apps=3, seed=0)
    else:
        m = pkg.hp_bl260c()
        graphs = [pkg.generate_app(pkg.SynthParams(n_tasks=(10, 20)),
                                   seed=100 + i) for i in range(2)]
    return m, graphs, [pkg.engine_schedule(g, m) for g in graphs]


@pytest.mark.parametrize("kind", ["8core", "64core"])
@pytest.mark.parametrize("jitter", [0.0, 0.01])
def test_torch_backend_equals_reference_pallas_bit_for_bit(kind, jitter):
    mr, gr, sr = suite(R, kind)
    mt, gt, st = suite(T, kind)
    seeds = [7 + i for i in range(len(gr))]
    want = R.simulate_suite(gr, mr, sr, jitter=jitter, seeds=seeds,
                            backend="pallas")
    got = T.simulate_suite(gt, mt, st, jitter=jitter, seeds=seeds,
                           backend="torch", device="cpu")
    np.testing.assert_array_equal(got.subtask_end, want.subtask_end)
    np.testing.assert_array_equal(got.t_exec, want.t_exec)
    np.testing.assert_array_equal(got.t_est, want.t_est)
    np.testing.assert_array_equal(got.dif_rel(), want.dif_rel())
    f64 = T.simulate_suite(gt, mt, st, jitter=jitter, seeds=seeds,
                           backend="numpy")
    np.testing.assert_allclose(got.subtask_end, f64.subtask_end,
                               rtol=RTOL_F32, atol=0.0)


def test_kernel_inputs_equal_reference_gather_inputs():
    """The kernel's (B, S, P+1) inputs, built in int32/float32, are the
    reference's float64 gather form rounded once."""
    from repro.core.sim_engine import _pop_gather_inputs as ref_inputs
    from repro_torch.core.sim_engine import _pop_gather_inputs
    mr, gr, sr = suite(R, "64core")
    mt, gt, st = suite(T, "64core")
    br = R.batch_scenarios([R.lower_scenario(g, mr, s)
                            for g, s in zip(gr, sr)])
    bt = T.batch_scenarios([T.lower_scenario(g, mt, s)
                            for g, s in zip(gt, st)])
    for got, want, dtype in zip(_pop_gather_inputs(bt), ref_inputs(br),
                                (np.int32, np.float32, np.float32)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want.astype(dtype))


@pytest.mark.parametrize("kind", ["8core", "64core"])
@pytest.mark.parametrize("jitter", [0.0, 0.01])
def test_numpy_backend_equals_reference_exactly(kind, jitter):
    mr, gr, sr = suite(R, kind)
    mt, gt, st = suite(T, kind)
    want = R.simulate_suite(gr * 2, mr, sr * 2, jitter=jitter,
                            backend="numpy")
    got = T.simulate_suite(gt * 2, mt, st * 2, jitter=jitter,
                           backend="numpy")
    for f in ("subtask_end", "t_exec", "t_est", "n_sub"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if jitter == 0.0:
        # contention-free, noise-free: T_exec reproduces T_est (Eq. 4 = 0)
        np.testing.assert_allclose(got.t_exec, got.t_est, rtol=1e-12)
    t32 = T.simulate_suite(gt * 2, mt, st * 2, jitter=jitter,
                           backend="torch", device="cpu")
    np.testing.assert_allclose(t32.subtask_end, got.subtask_end,
                               rtol=RTOL_F32, atol=0.0)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fault_scripts_take_the_fault_path(backend):
    """A reference ``FaultScript`` (read by attribute, never imported by
    the port) strands the same subtasks with the same finish times."""
    mr, gr, sr = suite(R, "8core")
    mt, gt, st = suite(T, "8core")
    scripts = [random_script(mr.n_cores, seed=20 + i,
                             horizon=s.makespan(), n_fail=1, n_slow=1,
                             n_degrade=1) for i, s in enumerate(sr)]
    scripts[1] = None                       # one healthy scenario
    want = R.simulate_suite(gr, mr, sr, faults=scripts, jitter=0.01)
    got = T.simulate_suite(gt, mt, st, faults=scripts, jitter=0.01,
                           backend=backend, device="cpu")
    np.testing.assert_array_equal(got.subtask_end, want.subtask_end)
    np.testing.assert_array_equal(got.t_exec, want.t_exec)
    assert np.isinf(got.subtask_end).any()


@pytest.mark.parametrize("sim", ["events", "arrays"])
@pytest.mark.parametrize("contention", [False, True])
def test_event_loops_equal_reference(sim, contention):
    mr, gr, sr = suite(R, "8core")
    mt, gt, st = suite(T, "8core")
    script = random_script(mr.n_cores, seed=4, horizon=sr[0].makespan(),
                           n_fail=1, n_slow=1, n_degrade=1)
    for i in range(len(gr)):
        kw = dict(contention=contention, jitter=0.02, seed=i,
                  faults=script if i == 0 else None)
        a = R.get_simulator(sim)(gr[i], mr, sr[i], **kw)
        b = T.get_simulator(sim)(gt[i], mt, st[i], **kw)
        assert (a.t_exec, a.subtask_end, a.stranded) == \
            (b.t_exec, b.subtask_end, b.stranded)


def test_cuda_backend_raises_without_a_gpu(monkeypatch):
    mt, gt, st = suite(T, "8core")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        T.simulate_suite(gt, mt, st)
    batch = T.batch_scenarios([T.lower_scenario(g, mt, s)
                               for g, s in zip(gt, st)])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        simulate_batch(batch, backend="cuda", device="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        simulate_batch(batch, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        simulate_batch(batch, backend="pallas", device="cpu")


def test_empty_graph_simulates_to_zero():
    m = T.dell_poweredge_1950()
    g = T.AppGraph(n_types=1)
    g.finalize()
    res = T.simulate_suite([g], m, [T.Schedule(m.n_cores)],
                           backend="torch", device="cpu")
    assert res.t_exec[0] == 0.0 and res.dif_rel()[0] == 0.0
