"""The CUDA kernels on the card: each equal to its plain PyTorch version
bit for bit, counted once per launch and guarded like the CPU path; the
``backend="cuda"`` simulator and GA fitness within the float32
tolerance of float64; kernel-scored admission placing exactly as the
plain version does.
Every test needs an NVIDIA GPU with ``nvcc``; elsewhere they skip. On
the card: ``python3 -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops, ref, sched_score, sim_step

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


# ---------------------------------------------------------------------------
# sched_score
# ---------------------------------------------------------------------------

def score_inputs(seed, a, c):
    """Float32 drains, frontiers and releases with ``±inf``, NaN, ties
    (signed zeros included) and subnormal drains mixed in."""
    rng = np.random.default_rng(seed)
    drain = rng.uniform(0.0, 500.0, (a, c)).astype(np.float32)
    f = rng.uniform(0.0, 1000.0, c).astype(np.float32)
    r = rng.uniform(0.0, 1000.0, a).astype(np.float32)
    drain[rng.random((a, c)) < 0.05] = np.float32(1e-40)
    drain[rng.random((a, c)) < 0.02] = -np.inf
    drain[rng.random((a, c)) < 0.02] = np.nan
    f[rng.random(c) < 0.1] = np.inf
    f[rng.random(c) < 0.05] = np.nan
    r[rng.random(a) < 0.1] = -np.inf
    r[rng.random(a) < 0.05] = np.nan
    k = min(a, c)
    f[:k] = np.where(rng.random(k) < 0.3, r[:k], f[:k])
    f[:k] = np.where(rng.random(k) < 0.1, np.float32(-0.0), f[:k])
    r[:k] = np.where(rng.random(k) < 0.1, np.float32(0.0), r[:k])
    return drain, f, r


def assert_same_scores(got, want):
    """Equal bit for bit wherever the result is a number (signed zeros
    and subnormals included); NaN at exactly the same places. Only a
    NaN's payload may differ between the card and the plain version."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("a,c", [(1, 1), (1, 256), (16, 1), (16, 256),
                                 (1000, 777), (3, 4097)])
def test_sched_score_kernel_equals_plain_version(cuda, a, c):
    args = on(cuda, score_inputs(a * 7 + c, a, c))
    before = ops.sched_score.launches
    got = ops.sched_score(*args)
    assert ops.sched_score.launches == before + 1
    want = sched_score.sched_score_torch(*args)
    torch.cuda.synchronize()
    assert_same_scores(got, want)
    oracle = torch.from_numpy(ref.sched_score_np(*(x.cpu().numpy()
                                                   for x in args)))
    assert_same_scores(got.cpu(), oracle)
    finite = [x.nan_to_num(nan=1.0) for x in args]
    assert torch.equal(ops.sched_score(*finite),
                       sched_score.sched_score_torch(*finite))


def test_sched_score_empty_and_guarded_on_the_card(cuda):
    before = ops.sched_score.launches
    for a, c in [(0, 5), (5, 0), (0, 0)]:
        out = ops.sched_score(torch.zeros((a, c), device=cuda),
                              torch.zeros(c, device=cuda),
                              torch.zeros(a, device=cuda))
        assert out.shape == (a, c) and out.device.type == "cuda"
    assert ops.sched_score.launches == before
    d, f, r = on(cuda, score_inputs(1, 4, 6))
    with pytest.raises(ValueError, match="several devices"):
        ops.sched_score(d, f.cpu(), r)
    with pytest.raises(TypeError, match="dtype"):
        ops.sched_score(d.double(), f, r)


def test_kernel_scored_admission_places_like_the_plain_version(cuda):
    from repro_torch.online import (ArrivalParams, evaluate,
                                    generate_workload, make_policy)
    m = T.cluster_of_multicores(n_blades=4)
    wl = generate_workload(ArrivalParams(rate=0.9 * 32 / 550,
                                         process="bursty"), n_apps=24, seed=3)
    before = ops.sched_score.launches
    got = make_policy("batched", k=8, scorer="kernel", device=cuda).run(m, wl)
    assert ops.sched_score.launches == before + 3
    want = make_policy("batched", k=8, scorer="kernel", device="cpu").run(m, wl)
    assert {s: (p.core, p.start, p.end)
            for s, p in got.schedule.placements.items()} \
        == {s: (p.core, p.start, p.end)
            for s, p in want.schedule.placements.items()}
    assert evaluate(got).row() == evaluate(want).row()


def test_ga_fitness_on_the_card_within_f32_tolerance(cuda):
    from repro_torch.search import population_fitness
    m = T.cluster_of_multicores(n_blades=4)
    g = T.generate_app(T.SynthParams(n_tasks=(40, 60)), seed=8)
    pop = np.random.default_rng(0).integers(0, m.n_cores,
                                            (16, len(g.tasks)),
                                            dtype=np.int32)
    before = ops.sim_relax_pop.launches
    got = population_fitness(g, m, pop, backend="cuda")
    assert ops.sim_relax_pop.launches == before + 1
    want = population_fitness(g, m, pop, backend="numpy")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
