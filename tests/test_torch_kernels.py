"""The port's ``sim_relax_pop`` layer on the CPU: its plain PyTorch
version against the JAX package's NumPy oracle and its interpret-mode
Pallas kernel (bit for bit: max and + only, in float32), the guarded
entry point's routing and checks, and the kernel build's command line.
The CUDA kernel itself runs only on the card (``test_torch_cuda.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.sim_step import pop_relax_np as jax_pop_relax_np
from repro.kernels.sim_step import pop_step_np as jax_pop_step_np
from repro_torch.kernels import build, ops, ref, sim_step

from test_torch_cuda import pop_inputs

ROOT = Path(__file__).resolve().parents[1]


def tensors(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.mark.parametrize("b,s,p1,n_steps", [(1, 1, 2, 3), (3, 17, 4, 9),
                                             (5, 130, 7, 20), (2, 64, 1, 0)])
def test_plain_equals_numpy_oracles_bit_for_bit(b, s, p1, n_steps):
    arrays = pop_inputs(b * 100 + s, b, s, p1)
    got = sim_step.sim_relax_pop_torch(*tensors(arrays), n_steps=n_steps)
    assert got.dtype == torch.float32 and got.shape == (b, s)
    want = jax_pop_relax_np(*arrays, n_steps=n_steps)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.pop_relax_np(*arrays, n_steps=n_steps),
                                  want)


def test_oracle_step_copy_matches_reference():
    pred, lat, volbw, dur, rel = pop_inputs(7, 3, 20, 5)
    end = np.random.default_rng(8).uniform(0, 50, (3, 21)).astype(np.float32)
    end[:, 20] = 0.0
    np.testing.assert_array_equal(
        ref.pop_step_np(end, pred, lat, volbw, dur, rel),
        jax_pop_step_np(end, pred, lat, volbw, dur, rel))


def test_plain_equals_jax_interpret_kernel_bit_for_bit():
    """The JAX package's Pallas ``sim_relax_pop`` in interpret mode (how
    it runs off-TPU) gives the same float32 bits as the plain version."""
    arrays = pop_inputs(3, 2, 40, 5)
    want = np.asarray(jax_ops.sim_relax_pop(*arrays, n_steps=12))
    got = ops.sim_relax_pop(*tensors(arrays), n_steps=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_point_runs_plain_version_on_cpu_without_counting():
    arrays = pop_inputs(11, 2, 30, 4)
    before = ops.sim_relax_pop.launches
    got = ops.sim_relax_pop(*tensors(arrays), n_steps=7)
    assert ops.sim_relax_pop.launches == before
    np.testing.assert_array_equal(
        got.numpy(), sim_step.sim_relax_pop_torch(*tensors(arrays),
                                                  n_steps=7).numpy())


def _bad_inputs(case):
    pred, lat, volbw, dur, rel = tensors(pop_inputs(5, 2, 10, 3))
    if case == "pred-dtype":
        pred = pred.long()
    elif case == "lat-dtype":
        lat = lat.double()
    elif case == "volbw-shape":
        volbw = volbw[:, :, :2].contiguous()
    elif case == "release-shape":
        rel = rel[:1]
    elif case == "not-contiguous":
        lat = lat.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "pred-past-sentinel":
        pred = pred.clone()
        pred[1, 3, 2] = 11
    elif case == "pred-negative":
        pred = pred.clone()
        pred[0, 0, 0] = -1
    elif case == "numpy-input":
        dur = dur.numpy()
    elif case == "pred-rank":
        pred = pred[0]
    return pred, lat, volbw, dur, rel


@pytest.mark.parametrize("case,exc", [
    ("pred-dtype", TypeError), ("lat-dtype", TypeError),
    ("volbw-shape", ValueError), ("release-shape", ValueError),
    ("not-contiguous", ValueError), ("pred-past-sentinel", IndexError),
    ("pred-negative", IndexError), ("numpy-input", TypeError),
    ("pred-rank", ValueError)])
def test_entry_point_guards_raise(case, exc):
    with pytest.raises(exc):
        ops.sim_relax_pop(*_bad_inputs(case), n_steps=2)


def test_entry_point_refuses_negative_steps_and_other_devices():
    good = tensors(pop_inputs(5, 2, 10, 3))
    with pytest.raises(ValueError, match="n_steps"):
        ops.sim_relax_pop(*good, n_steps=-1)
    meta = [x.to("meta") for x in good]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.sim_relax_pop(*meta, n_steps=1)


def test_sentinel_index_is_in_bounds():
    """``pred == S`` (the zero slot) is legal; an all-pad row evaluates
    to its duration plus its release floor."""
    b, s, p1 = 1, 4, 3
    pred = torch.full((b, s, p1), s, dtype=torch.int32)
    lat = torch.full((b, s, p1), -np.inf)
    dur = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    rel = torch.tensor([[0.0, 5.0, 0.0, 0.5]])
    got = ops.sim_relax_pop(pred, lat, lat.clone(), dur, rel, n_steps=2)
    np.testing.assert_array_equal(got.numpy(), [[1.0, 7.0, 3.0, 4.5]])


def test_shared_memory_need_of_a_block():
    assert sim_step.shared_bytes(1700) < 48 * 1024
    assert sim_step.shared_bytes(29_055) <= sim_step.MAX_SHARED_BYTES
    assert sim_step.shared_bytes(29_056) > sim_step.MAX_SHARED_BYTES


def test_build_route_flags_and_ignored_output_dir(monkeypatch):
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    out = build.library_path("sim_relax_pop")
    cmd = build.nvcc_command("sim_relax_pop", out)
    assert cmd[:2] == ["nvcc", "-gencode"]
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert out.parent == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sources == ["flash_attention", "flash_decode", "rmsnorm",
                       "sched_score", "sim_relax_pop", "sim_step",
                       "ssd_scan"]
