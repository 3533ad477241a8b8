"""The CUDA kernel on the card: equal to its plain PyTorch version bit
for bit, counted once per launch, guarded like the CPU path, and the
``backend="cuda"`` simulator within the float32 tolerance of float64.
Every test needs an NVIDIA GPU with ``nvcc``; elsewhere they skip. On
the card: ``python3 -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops, sim_step

pytestmark = pytest.mark.cuda


def pop_inputs(seed, b, s, p1, pad_frac=0.3):
    """Random gather-form inputs made with NumPy: sentinel pads with -inf
    lags, sparse release floors. Random sources may form cycles, so the
    sweeps never settle — every sweep's arithmetic is compared."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, s + 1, (b, s, p1)).astype(np.int32)
    lat = rng.uniform(0.0, 1e-3, (b, s, p1)).astype(np.float32)
    volbw = rng.uniform(0.0, 5.0, (b, s, p1)).astype(np.float32)
    pads = rng.random((b, s, p1)) < pad_frac
    pred[pads] = s
    lat[pads] = -np.inf
    volbw[pads] = -np.inf
    dur = rng.uniform(0.1, 10.0, (b, s)).astype(np.float32)
    rel = np.where(rng.random((b, s)) < 0.2,
                   rng.uniform(0.0, 20.0, (b, s)), 0.0).astype(np.float32)
    return pred, lat, volbw, dur, rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda:0")


def on(device, arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays]


@pytest.mark.parametrize("b,s,p1,n_steps", [(1, 1, 2, 3), (3, 17, 4, 9),
                                             (5, 1300, 7, 20), (2, 64, 1, 0),
                                             (4, 12_000, 3, 5)])
def test_kernel_equals_plain_version(cuda, b, s, p1, n_steps):
    args = on(cuda, pop_inputs(b * 100 + s, b, s, p1))
    before = ops.sim_relax_pop.launches
    got = ops.sim_relax_pop(*args, n_steps=n_steps)
    assert ops.sim_relax_pop.launches == before + 1
    want = sim_step.sim_relax_pop_torch(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_guards_on_the_card(cuda):
    pred, lat, volbw, dur, rel = on(cuda, pop_inputs(1, 2, 10, 3))
    bad = pred.clone()
    bad[0, 0, 0] = 11
    with pytest.raises(IndexError):
        ops.sim_relax_pop(bad, lat, volbw, dur, rel, n_steps=2)
    with pytest.raises(ValueError, match="several devices"):
        ops.sim_relax_pop(pred, lat, volbw, dur.cpu(), rel, n_steps=2)
    s = 29_056
    big = [torch.full((1, s, 1), s, dtype=torch.int32, device=cuda),
           torch.zeros((1, s, 1), device=cuda),
           torch.zeros((1, s, 1), device=cuda),
           torch.zeros((1, s), device=cuda), torch.zeros((1, s), device=cuda)]
    with pytest.raises(ValueError, match="shared memory"):
        ops.sim_relax_pop(*big, n_steps=1)


def test_cuda_simulate_suite_within_f32_tolerance(cuda):
    m = T.hp_bl260c()
    graphs = [T.generate_app(T.SynthParams(n_tasks=(120, 200)), seed=100 + i)
              for i in range(2)]
    scheds = [T.engine_schedule(g, m) for g in graphs]
    got = T.simulate_suite(graphs, m, scheds, jitter=0.01, device=cuda)
    want = T.simulate_suite(graphs, m, scheds, jitter=0.01, backend="numpy")
    np.testing.assert_allclose(got.subtask_end, want.subtask_end, rtol=1e-5,
                               atol=0.0)
    plain = T.simulate_suite(graphs, m, scheds, jitter=0.01, backend="torch",
                             device=cuda)
    np.testing.assert_array_equal(got.subtask_end, plain.subtask_end)
