"""The port's dense relaxation on the CPU: ``dense_lags``,
``relax_batch_np`` and ``population_arrays`` against the JAX package's
(array for array, exactly: the same NumPy code in the same order), and
the ``sim_step`` kernel's plain PyTorch version against the reference's
interpret-mode Pallas ``sim_step`` / ``sim_relax`` and its NumPy oracle
``sim_step_np``.

Tolerances: the dense sweep is ``+`` and ``max`` only, in float32, with
the adds in the order ``(end + lat) + volbw``, so the plain version, the
oracle and the Pallas kernel agree bit for bit (also with fewer sweeps
than the depth). Against the float64 CSR relaxations the float32 sweep
is held to rtol 1e-5, the reference's float32 tolerance. The lags are
drawn as ``tests/test_sim_engine.py`` draws them, in a range where no
sum is subnormal (XLA on the CPU flushes subnormals in interpret mode).
The CUDA kernel itself runs only on the card (``test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.lowering import dense_lags as jax_dense_lags
from repro.core.sim_engine import relax_batch_np as jax_relax_batch_np
from repro.kernels.sim_step import sim_relax as jax_sim_relax
from repro.kernels.sim_step import sim_step as jax_sim_step
from repro.kernels.sim_step import sim_step_np as jax_sim_step_np
from repro_torch.core.lowering import dense_lags, population_arrays
from repro_torch.core.sim_engine import relax_batch_np, relax_wave_np
from repro_torch.kernels import ops, ref, sim_step

from test_torch_cuda import dense_inputs

RTOL_F32 = 1e-5


def tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


MACHINES = {"8core": lambda pkg: pkg.dell_poweredge_1950(),
            "16core-hetero": lambda pkg: pkg.cluster_of_multicores(
                n_blades=2, n_types=2),
            "64core": lambda pkg: pkg.hp_bl260c()}


def lowered(pkg, kind, n_apps=3, seed=0):
    """A lowered batch of engine schedules of small synthetic apps."""
    m = MACHINES[kind](pkg)
    n_types = 2 if "hetero" in kind else 1
    graphs = [pkg.generate_app(pkg.SynthParams(n_tasks=(5, 12),
                                               n_types=n_types), seed + i)
              for i in range(n_apps)]
    return pkg.batch_scenarios([pkg.lower_scenario(g, m,
                                                   pkg.engine_schedule(g, m))
                                for g in graphs])


@pytest.mark.parametrize("kind", sorted(MACHINES))
def test_dense_lags_equal_reference(kind):
    lat, volbw = dense_lags(lowered(T, kind))
    want_lat, want_volbw = jax_dense_lags(lowered(R, kind))
    assert lat.dtype == np.float64 and lat.shape == want_lat.shape
    np.testing.assert_array_equal(lat, want_lat)
    np.testing.assert_array_equal(volbw, want_volbw)


def test_dense_lags_keep_the_larger_of_parallel_edges():
    """Two edges q -> t in one row: the one with the larger total lag
    wins, its own split of lat and vol/bw kept, as in the reference."""
    out = []
    for pkg, fn in ((R, jax_dense_lags), (T, dense_lags)):
        batch = lowered(pkg, "8core", n_apps=1)
        s, p = batch.max_subtasks, batch.max_preds
        pred = np.full((1, s, p + 1), s, np.int32)
        pred[:, :, :p] = batch.pred
        lat = np.full((1, s, p + 1), -np.inf)
        lat[:, :, :p] = batch.pred_lat
        vb = np.full((1, s, p + 1), -np.inf)
        vb[:, :, :p] = batch.pred_volbw
        t = int(np.argmax((batch.pred[0] < s).sum(axis=1)))
        q = int(batch.pred[0, t, 0])
        pred[0, t, p], lat[0, t, p], vb[0, t, p] = q, 5.0, 7.0
        twin = dataclasses.replace(batch, max_preds=p + 1, pred=pred,
                                   pred_lat=lat, pred_volbw=vb)
        dl, dv = fn(twin)
        assert (dl[0, t, q], dv[0, t, q]) == (5.0, 7.0)
        out.append((dl, dv))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("kind", ["8core", "16core-hetero"])
@pytest.mark.parametrize("n_steps", [None, 1, 3])
def test_relax_batch_np_equals_reference(kind, n_steps):
    tb, rb = lowered(T, kind), lowered(R, kind)
    dur = np.random.default_rng(4).uniform(0.5, 2.0, tb.duration.shape) \
        * tb.duration
    np.testing.assert_array_equal(relax_batch_np(tb, dur, n_steps),
                                  jax_relax_batch_np(rb, dur, n_steps))
    if n_steps is None:             # the fixpoint: the wave pass's values
        np.testing.assert_array_equal(relax_batch_np(tb, dur),
                                      relax_wave_np(tb, dur))


@pytest.mark.parametrize("kind", sorted(MACHINES))
def test_population_arrays_equal_reference(kind):
    n_types = 2 if "hetero" in kind else 1
    got, want = (population_arrays(
        pkg.generate_app(pkg.SynthParams(n_tasks=(10, 16), n_types=n_types),
                         3), MACHINES[kind](pkg)) for pkg in (T, R))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_population_arrays_cached_on_the_graph():
    g = T.generate_app(T.SynthParams(n_tasks=(6, 9)), 1)
    m = T.dell_poweredge_1950()
    assert population_arrays(g, m) is population_arrays(g, m)


@pytest.mark.parametrize("b,s", [(3, 37), (2, 1), (1, 130)])
def test_sim_step_plain_equals_pallas_and_oracle_bit_for_bit(b, s):
    arrays = dense_inputs(b * 1000 + s, b, s)
    got = sim_step.sim_step_torch(*tensors(arrays))
    assert got.dtype == torch.float32 and got.shape == (b, s)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sim_step(*arrays, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), jax_sim_step_np(*arrays))
    np.testing.assert_array_equal(ref.sim_step_ref(*arrays),
                                  jax_sim_step_np(*arrays))


def batch_dense_inputs(kind):
    """The dense path's inputs for a lowered batch, in float32: the
    port's ``dense_lags`` and the batch's durations and floors."""
    batch = lowered(T, kind)
    lat, volbw = dense_lags(batch)
    return batch, [np.ascontiguousarray(x, np.float32) for x in
                   (lat, volbw, batch.duration, batch.release)]


@pytest.mark.parametrize("kind", ["8core", "16core-hetero"])
@pytest.mark.parametrize("below_depth", [False, True])
def test_sim_relax_plain_equals_pallas_on_a_lowered_batch(kind, below_depth):
    """On a lowered 8-core batch, at the depth and below it (where the
    Jacobi sweep has not settled, so an in-place update would differ)."""
    batch, arrays = batch_dense_inputs(kind)
    steps = batch.depth // 2 if below_depth else batch.depth
    got = sim_step.sim_relax_torch(*tensors(arrays), n_steps=steps)
    want = np.asarray(jax_sim_relax(*arrays, n_steps=steps, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.sim_relax(*tensors(arrays), n_steps=steps), got)


@pytest.mark.parametrize("kind", ["8core", "16core-hetero", "64core"])
def test_sim_relax_plain_within_f32_of_float64_relaxations(kind):
    batch, arrays = batch_dense_inputs(kind)
    got = sim_step.sim_relax_torch(*tensors(arrays),
                                   n_steps=batch.depth).numpy()
    for want in (relax_wave_np(batch), relax_batch_np(batch)):
        np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=0.0)


def test_sim_step_plain_propagates_nan_like_the_oracle():
    end, lat, volbw, dur, rel = dense_inputs(9, 2, 20)
    lat[0, 3, 5] = np.nan           # one row's max
    end[1, 7] = np.inf              # inf + -inf: NaN where 7 is no edge
    dur[0, 11] = np.nan
    rel[0, 12] = np.nan
    got = sim_step.sim_step_torch(*tensors((end, lat, volbw, dur, rel)))
    want = jax_sim_step_np(end, lat, volbw, dur, rel)
    np.testing.assert_array_equal(got.numpy(), want)   # NaN at NaN
    assert np.isnan(want[0, [3, 11, 12]]).all() and np.isnan(want[1]).any()


def test_entry_points_run_plain_version_on_cpu_without_counting():
    arrays = dense_inputs(11, 2, 30)
    before = (ops.sim_step.launches, ops.sim_relax.launches)
    got = ops.sim_step(*tensors(arrays))
    relaxed = ops.sim_relax(*tensors(arrays[1:]), n_steps=4)
    assert (ops.sim_step.launches, ops.sim_relax.launches) == before
    assert torch.equal(got, sim_step.sim_step_torch(*tensors(arrays)))
    assert torch.equal(relaxed,
                       sim_step.sim_relax_torch(*tensors(arrays[1:]),
                                                n_steps=4))


def test_entry_points_on_empty_shapes_and_zero_steps():
    for b, s in ((0, 5), (3, 0)):
        end, lat, volbw, dur, rel = (torch.zeros((b, s)),
                                     torch.zeros((b, s, s)),
                                     torch.zeros((b, s, s)),
                                     torch.zeros((b, s)), torch.zeros((b, s)))
        assert ops.sim_step(end, lat, volbw, dur, rel).shape == (b, s)
        assert ops.sim_relax(lat, volbw, dur, rel, n_steps=3).shape == (b, s)
    _, lat, volbw, dur, rel = tensors(dense_inputs(2, 2, 9))
    assert torch.equal(ops.sim_relax(lat, volbw, dur, rel, n_steps=0),
                       torch.zeros((2, 9)))


def _bad_dense(case):
    end, lat, volbw, dur, rel = tensors(dense_inputs(5, 2, 10))
    if case == "lat-dtype":
        lat = lat.double()
    elif case == "end-dtype":
        end = end.half()
    elif case == "volbw-shape":
        volbw = volbw[:, :, :9].contiguous()
    elif case == "lat-not-square":
        lat, volbw = lat[:, :9].contiguous(), volbw[:, :9].contiguous()
    elif case == "release-shape":
        rel = rel[:1]
    elif case == "end-shape":
        end = end[:, :4].contiguous()
    elif case == "not-contiguous":
        lat = lat.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "numpy-input":
        dur = dur.numpy()
    elif case == "lat-rank":
        lat = lat[0]
    elif case == "several-devices":
        end = end.to("meta")
    elif case == "meta-device":
        end, lat, volbw, dur, rel = (x.to("meta")
                                     for x in (end, lat, volbw, dur, rel))
    return end, lat, volbw, dur, rel


@pytest.mark.parametrize("case,exc", [
    ("lat-dtype", TypeError), ("end-dtype", TypeError),
    ("volbw-shape", ValueError), ("lat-not-square", ValueError),
    ("release-shape", ValueError), ("end-shape", ValueError),
    ("not-contiguous", ValueError), ("numpy-input", TypeError),
    ("lat-rank", ValueError), ("several-devices", ValueError),
    ("meta-device", ValueError)])
def test_entry_points_guards_raise(case, exc):
    end, lat, volbw, dur, rel = _bad_dense(case)
    with pytest.raises(exc):
        ops.sim_step(end, lat, volbw, dur, rel)
    if case not in ("end-dtype", "end-shape", "several-devices"):
        with pytest.raises(exc):        # sim_relax takes no end
            ops.sim_relax(lat, volbw, dur, rel, n_steps=2)


def test_sim_relax_refuses_negative_steps():
    _, lat, volbw, dur, rel = tensors(dense_inputs(5, 2, 10))
    with pytest.raises(ValueError, match="n_steps"):
        ops.sim_relax(lat, volbw, dur, rel, n_steps=-1)


def test_cpu_tensors_never_load_the_kernel_library(monkeypatch):
    """On CPU tensors the guards take the plain version without asking
    the library anything: not even the shared-memory limit, which only
    the kernel has."""
    def no_library(name):
        raise AssertionError(f"library {name} loaded for CPU tensors")
    monkeypatch.setattr(sim_step.build, "load", no_library)
    end, lat, volbw, dur, rel = tensors(dense_inputs(8, 2, 60))
    want = sim_step.sim_step_torch(end, lat, volbw, dur, rel)
    assert torch.equal(ops.sim_step(end, lat, volbw, dur, rel), want)
    assert torch.equal(ops.sim_relax(lat, volbw, dur, rel, n_steps=3),
                       sim_step.sim_relax_torch(lat, volbw, dur, rel,
                                                n_steps=3))
