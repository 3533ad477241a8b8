"""The CUDA kernels on the card: each equal to its plain PyTorch version
(bit for bit for the scheduling kernels and the dense ``sim_step``; within the tolerance stated at
``assert_close_to_plain`` for the serving kernels), counted once per
launch and guarded like the CPU path; the ``backend="cuda"`` simulator
and GA fitness within the float32 tolerance of float64; kernel-scored
admission placing exactly as the plain version does; the device GA's
kernel fitness equal to its scan; reduced-model greedy decoding on the
card giving the CPU's tokens.
Every test needs an NVIDIA GPU with ``nvcc``; elsewhere they skip. On
the card: ``python3 -m pytest -q -m cuda tests/test_torch_cuda.py``."""

import contextlib
import copy

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import (flash_attention, flash_decode, ops, ref,
                                 rmsnorm, sched_score, sim_step, ssd_scan)

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


def dense_inputs(seed, b, s, edge_frac=0.2):
    """Random dense sweep inputs made with NumPy, float32: ``-inf``
    non-edges, lags drawn as the reference's kernel test draws them (a
    range where no sum is subnormal)."""
    rng = np.random.default_rng(seed)
    lat = np.where(rng.uniform(size=(b, s, s)) < edge_frac,
                   rng.uniform(0.0, 1e-4, (b, s, s)), -np.inf)
    volbw = np.where(lat > -np.inf, rng.uniform(0.0, 2.0, (b, s, s)),
                     -np.inf)
    end = rng.uniform(0.0, 50.0, (b, s))
    dur = rng.uniform(0.1, 5.0, (b, s))
    rel = rng.uniform(0.0, 20.0, (b, s))
    return [x.astype(np.float32) for x in (end, lat, volbw, dur, rel)]


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


def dag_inputs(seed, b, s, p1):
    """``pop_inputs`` made acyclic (every source before its subtask, else
    the sentinel), so that rows settle and the kernel's stop shows."""
    pred, lat, volbw, dur, rel = pop_inputs(seed, b, s, p1)
    pred = np.where(pred < np.arange(s)[None, :, None], pred,
                    s).astype(np.int32)
    return pred, lat, volbw, dur, rel


def staging_limit(b, p1):
    """The least S at which ``pop_plan`` leaves the staged variant."""
    s = 32
    while sim_step.pop_plan(b, s, p1).variant == "staged":
        s += 1
    return s


# (B, S, P+1, n_steps, inputs, k, variant): every cluster size the rule
# picks, both variants, cyclic inputs, n_steps 0, 1 and below the depth,
# odd B; S = None is just under / over the staging limit at (1, *, 64)
POP_PLAN_CASES = [
    (132, 300, 5, 300, "dag", 1, "staged"),
    (66, 300, 5, 300, "dag", 2, "staged"),
    (33, 300, 5, 300, "dag", 4, "staged"),
    (16, 600, 5, 600, "dag", 8, "staged"),
    (3, 2000, 9, 2000, "dag", 16, "staged"),
    (160, 815, 28, 200, "dag", 1, "l2"),
    (40, 2000, 23, 300, "dag", 2, "l2"),
    (1, "under", 64, 400, "dag", 16, "staged"),
    (1, "over", 64, 400, "dag", 16, "l2"),
    (33, 400, 6, 50, "cyclic", 4, "staged"),
    (5, 1300, 7, 20, "cyclic", 16, "staged"),
    (33, 500, 5, 0, "dag", 4, "staged"),
    (33, 500, 5, 1, "dag", 4, "staged"),
    (33, 500, 5, 3, "dag", 4, "staged"),
]


@pytest.mark.parametrize("b,s,p1,n_steps,kind,k,variant", POP_PLAN_CASES)
def test_sim_relax_pop_equals_plain_under_every_plan(cuda, b, s, p1, n_steps,
                                                     kind, k, variant):
    """Bit for bit against the plain version for each cluster size and
    variant, with the rows' sweeps no more than ``n_steps`` and equal to
    the plain stop's count (``fixpoint_sweeps_torch`` on the CPU)."""
    if not isinstance(s, int):
        limit = staging_limit(b, p1)
        s = limit - 1 if s == "under" else limit
    plan = sim_step.pop_plan(b, s, p1)
    assert (plan.k, plan.variant) == (k, variant)
    arrays = (dag_inputs if kind == "dag" else pop_inputs)(b + s, b, s, p1)
    args = on(cuda, arrays)
    before = ops.sim_relax_pop.launches
    got = ops.sim_relax_pop(*args, n_steps=n_steps)
    assert ops.sim_relax_pop.launches == before + 1
    again, sweeps = sim_step.sim_relax_pop_cuda(*args, n_steps=n_steps,
                                                with_sweeps=True)
    want = sim_step.sim_relax_pop_torch(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    _, cpu_sweeps = sim_step.fixpoint_sweeps_torch(
        *on("cpu", arrays), n_steps=n_steps)
    assert torch.equal(sweeps.cpu(), cpu_sweeps)
    assert int(sweeps.max()) <= n_steps
    if kind == "cyclic":
        assert int(sweeps.min()) == n_steps


def test_sim_relax_pop_plans_fit_the_card(cuda):
    """The occupancy query accepts the plan at the main paths' largest
    shapes and at the staging limit, and refuses a block past the
    shared memory one may use."""
    for b, s, p1 in [(32, 1090, 27), (160, 815, 28), (4, 1235, 31),
                     (64, 1235, 31), (32, 5628, 8), (1, 4785, 64),
                     (3, 17, 4)]:
        assert sim_step.max_active_clusters(
            sim_step.pop_plan(b, s, p1), 0) >= 1
    too_big = sim_step.PopPlan(1, "l2", sim_step.MAX_SHARED_BYTES + 4, 32)
    assert sim_step.max_active_clusters(too_big, 0) == 0


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
    # the fused row minimum: the same launch, equal under == to the
    # matrix's (the sign of a zero minimum is not pinned), NaN rows alike
    before = ops.sched_score.launches
    got, mins = ops.sched_score(*args, row_min=True)
    assert ops.sched_score.launches == before + 1
    assert_same_scores(got, want)
    want_min = want.amin(dim=1)
    nan = torch.isnan(want_min)
    assert torch.equal(torch.isnan(mins), nan)
    assert torch.equal(mins[~nan], want_min[~nan])
    np.testing.assert_array_equal(mins.cpu().numpy(),
                                  oracle.numpy().min(axis=1))


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


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("a,c", [(16, 256), (9, 64), (1000, 777)])
def test_sched_score_vector_and_scalar_paths_on_the_card(cuda, a, c, offset):
    """16-byte loads where C % 4 == 0 and the operands are aligned, scalar
    loads on views that start off 16 bytes and on a ragged C; both give
    the plain version's matrix and minima."""
    d, f, r = score_inputs(a + c + offset, a, c)
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.float32), d.ravel(), f, r])).to(cuda)
    args = (flat[offset:offset + a * c].view(a, c),
            flat[offset + a * c:offset + a * c + c],
            flat[offset + a * c + c:])
    want, want_min = sched_score.sched_score_torch(*args, row_min=True)
    got, mins = ops.sched_score(*args, row_min=True)
    assert sched_score.vector_path(args[0], args[1], got) \
        == (c % 4 == 0 and offset == 0)
    assert_same_scores(got, want)
    nan = torch.isnan(want_min)
    assert torch.equal(torch.isnan(mins), nan)
    assert torch.equal(mins[~nan], want_min[~nan])


def test_kernel_scores_stage_once_and_read_back_the_minima(cuda):
    """On the card, each batch packs its operands into one pinned buffer
    kept on the policy (grown, never shrunk), launches once and returns
    the plain version's scores."""
    from repro_torch.online import (ArrivalParams, BatchedPolicy,
                                    OnlineAMTHA, generate_workload)
    m = T.cluster_of_multicores(n_blades=4)
    wl = generate_workload(ArrivalParams(rate=0.9 * 32 / 550), n_apps=20,
                           seed=4)
    eng = OnlineAMTHA(m)
    for arr in wl[:4]:
        eng.admit(arr)
    pol = BatchedPolicy(k=8, scorer="kernel", device=cuda)
    cpu = BatchedPolicy(k=8, scorer="kernel", device="cpu")
    now = wl[4].t_arrival
    before = ops.sched_score.launches
    caps = []
    for batch in (wl[4:7], wl[4:16], wl[4:6]):
        assert pol.kernel_scores(batch, eng, now) \
            == cpu.kernel_scores(batch, eng, now)
        caps.append(pol._staging.numel())
        assert pol._staging.is_pinned()
    assert ops.sched_score.launches == before + 3
    assert caps[0] < caps[1] == caps[2]
    assert not cpu._staging.is_pinned()


def test_tracecheck_on_the_card(cuda):
    """Every manifest entry clean on the card; the kernels' launches seen
    through their counts; the admission scorer's one read-back."""
    from repro_torch.analysis.tracecheck import assert_clean, run_tracecheck
    reports = assert_clean(run_tracecheck(quick=True, device=cuda))
    by = {r.entry: r for r in reports}
    assert by["online.admission_score"].launches == {"sched_score": 1}
    assert by["online.admission_score"].host_syncs \
        == ("_to_copy(cuda->cpu)",)
    assert by["kernels.sched_score"].launches == {"sched_score": 1}
    assert by["kernels.sched_score"].host_syncs == ()
    assert by["sim.relax_pop"].launches == {"sim_relax_pop": 1}
    assert by["kernels.flash_attention"].launches == {"flash_attention": 1}


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


# ---------------------------------------------------------------------------
# the serving kernels: rmsnorm, flash_attention, flash_decode
# ---------------------------------------------------------------------------

def assert_close_to_plain(got, want):
    """float32: rtol 1e-5 with an absolute floor of 1e-5 x max|want|
    (sums taken in another order; outputs that cancel near zero).
    bfloat16: at most 2 bfloat16 ulps of max(|want|, max|want| / 256):
    both versions compute in float32 and round once, so they differ by a
    rounding step where their float32 values straddle a boundary."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.double(), want.double()
    amax = float(w.abs().max()) if w.numel() else 0.0
    if want.dtype == torch.float32:
        bound = 1e-5 * w.abs() + 1e-5 * amax
    else:
        mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
        bound = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (g - w).abs()
    assert bool((err <= bound).all()), \
        f"max abs err {float(err.max()):.3e} (max |want| {amax:.3e})"


def rand(cuda, shape, dtype, seed, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wdtype,zero_centered", [
    ((4, 512, 2304), None, False), ((7, 16), torch.float32, True),
    ((3, 1000), None, True), ((2, 5, 4, 256), torch.bfloat16, False)])
def test_rmsnorm_kernel_close_to_plain_version(cuda, dtype, shape, wdtype,
                                               zero_centered):
    x = rand(cuda, shape, dtype, 1)
    w = rand(cuda, shape[-1:], wdtype or dtype, 2, 0.1)
    before = ops.rmsnorm.launches
    got = ops.rmsnorm(x, w, zero_centered=zero_centered)
    assert ops.rmsnorm.launches == before + 1
    want = rmsnorm.rmsnorm_torch(x, w, zero_centered=zero_centered)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,softcap", [
    (4, 512, 8, 4, 256, True, 4096, 50.0),     # gemma2-2b, run A shape
    (1, 700, 8, 4, 256, True, 256, 50.0),      # window inside the prompt
    (2, 77, 4, 1, 64, True, None, 30.0),       # ragged, MQA
    (1, 100, 4, 2, 16, True, 16, None),        # reduced widths
    (3, 33, 6, 2, 128, False, None, None),     # bidirectional
    (1, 1, 2, 2, 32, True, 8, 50.0),           # one token
])
def test_flash_attention_kernel_close_to_plain_version(
        cuda, dtype, b, s, hq, hkv, d, causal, window, softcap):
    q = rand(cuda, (b, s, hq, d), dtype, 3)
    k = rand(cuda, (b, s, hkv, d), dtype, 4)
    v = rand(cuda, (b, s, hkv, d), dtype, 5)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert ops.flash_attention.launches == before + 1
    want = flash_attention.flash_attention_torch(
        q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,softcap", [
    (2, 700, 32, 32, 224, True, None, None),   # zamba2-7b's shared block
    (1, 200, 4, 2, 80, True, None, None),      # head dims off 64 and 128
    (1, 200, 4, 2, 96, True, 64, 50.0),
    (1, 1, 4, 2, 128, True, None, None),       # S around the 128-row tile
    (1, 64, 4, 2, 128, True, None, None),
    (2, 127, 4, 2, 256, True, None, 50.0),
    (1, 128, 4, 2, 256, True, None, None),
    (2, 129, 4, 2, 64, True, None, 30.0),
    (1, 300, 4, 2, 64, True, 16, None),        # a window inside a KV tile
    (1, 300, 4, 2, 128, True, 200, 50.0),      # one across KV tiles
    (1, 300, 4, 2, 64, True, 300, None),       # windows >= S
    (1, 300, 4, 2, 64, True, 1000, None),
    (1, 333, 16, 2, 128, True, None, None),    # GQA 8:1
    (2, 250, 4, 2, 64, False, 100, None),      # bidirectional window
])
def test_flash_attention_kernels_at_the_tile_edges(
        cuda, dtype, b, s, hq, hkv, d, causal, window, softcap):
    """bfloat16 through the tensor-core kernel, float32 through the SIMT
    kernel, at head dims, sequence lengths and windows around their
    tiles (64-column boxes, 128 query rows, 64-key tiles)."""
    q = rand(cuda, (b, s, hq, d), dtype, 13)
    k = rand(cuda, (b, s, hkv, d), dtype, 14)
    v = rand(cuda, (b, s, hkv, d), dtype, 15)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert ops.flash_attention.launches == before + 1
    want = flash_attention.flash_attention_torch(
        q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,dv", [
    (4, 512, 16, 192, 128),        # deepseek-v2-lite MLA prefill, run A
    (1, 4096, 16, 192, 128),       # run B
    (2, 77, 4, 192, 128),          # ragged S
    (1, 300, 4, 96, 64),           # D and Dv in two tile sizes
    (1, 130, 4, 64, 128),          # Dv > D
])
def test_flash_attention_kernel_with_d_unequal_dv(cuda, dtype, b, s, h, d,
                                                  dv):
    """q/k heads of D, v heads of Dv != D (MLA's nope + rope against v):
    the tensor-core kernel pads to max(D, Dv) (Q and K maps D wide, V
    Dv wide, O stored at Dv); causal, scale (D)^-0.5 as the model's."""
    q = rand(cuda, (b, s, h, d), dtype, 21)
    k = rand(cuda, (b, s, h, d), dtype, 22)
    v = rand(cuda, (b, s, h, dv), dtype, 23)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, scale=d ** -0.5)
    assert ops.flash_attention.launches == before + 1
    assert got.shape == (b, s, h, dv)
    want = flash_attention.flash_attention_torch(q, k, v, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


def test_flash_attention_bf16_launches_are_bitwise_equal(cuda):
    """No atomics and a fixed order of products: two launches of the
    tensor-core kernel on the same inputs give the same bits."""
    q = rand(cuda, (2, 1000, 8, 256), torch.bfloat16, 16)
    k = rand(cuda, (2, 1000, 4, 256), torch.bfloat16, 17)
    v = rand(cuda, (2, 1000, 4, 256), torch.bfloat16, 18)
    kw = dict(window=300, softcap=50.0)
    first = ops.flash_attention(q, k, v, **kw)
    second = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,s,hq,hkv,d,window,softcap", [
    (1, 700, 8, 4, 256, 256, 50.0), (2, 300, 32, 32, 224, None, None),
    (1, 129, 4, 1, 80, None, 30.0)])
def test_flash_attention_float32_meets_rtol_through_the_simt_kernel(
        cuda, b, s, hq, hkv, d, window, softcap):
    """float32 stays on the SIMT kernel (no tensor-core form keeps float32's
    rtol 1e-5)."""
    q, k, v = (rand(cuda, (b, s, h, d), torch.float32, 19 + i)
               for i, h in enumerate((hq, hkv, hkv)))
    kw = dict(window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


def test_flash_attention_refuses_what_its_tma_loads_cannot_take(cuda):
    """bfloat16 on the card: head dims that are multiples of 8 and 16-byte
    aligned tensors, or a ValueError before anything launches; float32
    (the SIMT kernel) takes both. The rule is the library's
    (``flash_attention_fits``), read through ``refusal``."""
    def qkv(d, dtype, offset=0):
        flat = rand(cuda, (3 * 2 * 40 * 4 * d + offset,), dtype, 20)
        return [flat[offset + i * 320 * d:offset + (i + 1) * 320 * d]
                .view(2, 40, 4, d) for i in range(3)]
    fa = flash_attention
    assert fa.refusal(*qkv(16, torch.bfloat16)) is None
    assert "multiples of 8" in fa.refusal(*qkv(20, torch.bfloat16))
    assert "q, k, v not 16-byte aligned" in fa.refusal(
        *qkv(16, torch.bfloat16, 1))
    assert fa.refusal(*qkv(20, torch.float32)) is None
    assert fa.refusal(*qkv(16, torch.float32, 1)) is None
    assert "exceed the kernel's 256" in fa.refusal(*qkv(264, torch.float32))
    counts = ops.flash_attention.launches
    for args in (qkv(20, torch.bfloat16), qkv(64, torch.bfloat16, 1)):
        assert all(x.is_contiguous() for x in args)
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(*args)
    assert ops.flash_attention.launches == counts
    for args in (qkv(20, torch.float32), qkv(64, torch.float32, 1)):
        got = ops.flash_attention(*args)
        torch.cuda.synchronize()
        assert_close_to_plain(got,
                              flash_attention.flash_attention_torch(*args))
    assert ops.flash_attention.launches == counts + 2


@pytest.mark.parametrize("rows", [1, 4000])
@pytest.mark.parametrize("d", [1536, 3072, 3584, 7168])
def test_rmsnorm_kernel_at_the_path_widths(cuda, rows, d):
    """The serving path's widths (mamba2-780m, zamba2-7b and its shared
    block), one decode row and a 4,000-row prefill, through the vector
    path."""
    assert rmsnorm.row_threads(d, torch.bfloat16) > 0
    x = rand(cuda, (rows, d), torch.bfloat16, 21)
    w = rand(cuda, (d,), torch.bfloat16, 22, 0.1)
    got = ops.rmsnorm(x, w, zero_centered=True)
    want = rmsnorm.rmsnorm_torch(x, w, zero_centered=True)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


def test_rmsnorm_kernel_scalar_path(cuda):
    """What the vector path cannot take goes through the scalar one: an
    ``x[..., 1:]`` copy made contiguous at d = 1001 (not a multiple of the
    vector), and a contiguous view 2 bytes off 16-byte alignment at
    d = 1000."""
    assert rmsnorm.row_threads(1001, torch.bfloat16) == 0
    assert rmsnorm.row_threads(1000, torch.bfloat16) == 32
    base = rand(cuda, (37, 1002), torch.bfloat16, 23)
    flat = rand(cuda, (37 * 1000 + 1,), torch.bfloat16, 24)
    for x in (base[..., 1:].contiguous(), flat[1:].view(37, 1000)):
        assert x.is_contiguous()
        w = rand(cuda, x.shape[-1:], torch.float32, 25, 0.1)
        got = ops.rmsnorm(x, w)
        want = rmsnorm.rmsnorm_torch(x, w)
        torch.cuda.synchronize()
        assert_close_to_plain(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hq,hkv,d,ring,softcap,pos", [
    (4, 544, 8, 4, 256, False, 50.0, [511, 300, 0, 543]),
    (4, 544, 8, 4, 256, True, 50.0, [600, 543, 10, 2000]),
    (1, 4096, 8, 4, 256, True, 50.0, [4700]),
    (2, 40, 4, 2, 16, False, None, [3, 39]),
    (3, 100, 8, 1, 64, True, 30.0, [0, 99, 150]),
    (2, 716, 32, 32, 224, False, None, [700, 715]),   # zamba2-7b run D
    (1, 4624, 8, 4, 256, False, 50.0, [4623]),        # gemma2-2b run B
    (3, 300, 6, 2, 20, False, None, [0, 1, 298]),     # D off the vector
    (2, 333, 4, 2, 20, True, 50.0, [2, 5000]),        # and a wrapped ring
    (4, 130, 8, 4, 256, True, None, [0, 129, 130, 9999]),
    (4, 544, 64, 4, 128, False, None, [511, 543, 512, 530]),  # qwen3 G=16
    (1, 37, 64, 4, 128, False, None, [36]),
])
def test_flash_decode_kernel_close_to_plain_version(
        cuda, dtype, b, t, hq, hkv, d, ring, softcap, pos):
    q = rand(cuda, (b, hq, d), dtype, 6)
    kc = rand(cuda, (b, t, hkv, d), dtype, 7)
    vc = rand(cuda, (b, t, hkv, d), dtype, 8)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, kc, vc, p, softcap=softcap, ring=ring)
    assert ops.flash_decode.launches == before + 1
    want = flash_decode.flash_decode_torch(q, kc, vc, p, softcap=softcap,
                                           ring=ring)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_launches_are_bitwise_equal(cuda, dtype):
    """Two launches at run B's shape (66 ranges per kv head) give the same
    bits: the combine sums the ranges in a fixed order, no atomics."""
    q = rand(cuda, (1, 8, 256), dtype, 1)
    kc = rand(cuda, (1, 4624, 4, 256), dtype, 2)
    vc = rand(cuda, (1, 4624, 4, 256), dtype, 3)
    p = torch.tensor([4623], dtype=torch.int32, device=cuda)
    first = ops.flash_decode(q, kc, vc, p, softcap=50.0)
    for _ in range(3):
        assert torch.equal(ops.flash_decode(q, kc, vc, p, softcap=50.0),
                           first)


def test_flash_decode_plan_bytes_match_the_library(cuda):
    lib = flash_decode._library()
    for d, dv, gr, size in ((256, 256, 2, 2), (224, 224, 1, 2),
                            (20, 20, 4, 2), (256, 256, 2, 4),
                            (64, 32, 4, 4)):
        assert lib.flash_decode_shared_bytes(d, dv, gr, size) == \
            flash_decode.decode_shared_bytes(d, dv, gr, size)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 8])
def test_flash_decode_lse_over_slot_ranges_on_the_card(cuda, dtype, m):
    """glm4-9b's decode head shape (32 q heads, 2 kv heads of 128) with
    the cache cut into ``m`` slot ranges, as a model axis of ``m`` cuts
    it; row 1 ends in the first range, so its other ranges have no valid
    slot (a local ``pos`` of -1). Each range's float32 out and lse against
    the plain version's (lse within rtol 1e-5), an empty range's out 0
    and lse -inf; the ranges merged (``merge_ranges``) and rounded once
    against the whole cache's kernel and plain version (the gate of
    ``assert_close_to_plain``: 2 bf16 ulps); one launch a range."""
    from repro_torch.kernels.flash_decode import merge_ranges
    b, t, hq, hkv, d = 2, 1024, 32, 2, 128
    q = rand(cuda, (b, hq, d), dtype, 11)
    kc = rand(cuda, (b, t, hkv, d), dtype, 12)
    vc = rand(cuda, (b, t, hkv, d), dtype, 13)
    pos = torch.tensor([t - 1, 100], dtype=torch.int32, device=cuda)
    whole = ops.flash_decode(q, kc, vc, pos)
    want = flash_decode.flash_decode_torch(q, kc, vc, pos)
    tl = t // m
    parts = []
    before = ops.flash_decode.launches
    for r in range(m):
        sl = slice(r * tl, (r + 1) * tl)
        loc = (torch.clamp(pos + 1 - r * tl, 0, tl) - 1).to(torch.int32)
        args = (q, kc[:, sl].contiguous(), vc[:, sl].contiguous(), loc)
        out, lse = ops.flash_decode(*args, return_lse=True)
        p_out, p_lse = flash_decode.flash_decode_torch(*args,
                                                       return_lse=True)
        assert out.dtype == lse.dtype == torch.float32
        assert_close_to_plain(out, p_out)
        finite = torch.isfinite(p_lse)
        assert torch.equal(torch.isfinite(lse), finite)
        torch.testing.assert_close(lse[finite], p_lse[finite], rtol=1e-5,
                                   atol=1e-5)
        if not bool(finite.all()):
            assert float(out[~finite].abs().max()) == 0.0
        parts.append((out, lse))
    assert ops.flash_decode.launches == before + m
    merged, _ = merge_ranges(*zip(*parts))
    assert_close_to_plain(merged.to(dtype), want)
    assert_close_to_plain(merged.to(dtype), whole)


def test_serving_kernels_refuse_bad_input_without_falling_back(cuda):
    q = rand(cuda, (2, 10, 4, 16), torch.float32, 1)
    k = rand(cuda, (2, 10, 2, 16), torch.float32, 2)
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    pos = torch.tensor([10, 3], dtype=torch.int32, device=cuda)
    for exc, call in [
            (ValueError, lambda: ops.rmsnorm(q, torch.zeros(16))),
            (TypeError, lambda: ops.rmsnorm(q.double(),
                                            torch.zeros(16, device=cuda))),
            (ValueError, lambda: ops.flash_attention(q, k, k.cpu())),
            (TypeError, lambda: ops.flash_attention(q, k.bfloat16(), k)),
            (ValueError, lambda: ops.flash_attention(q, k, k, window=0)),
            (ValueError, lambda: ops.flash_attention(
                *(rand(cuda, (1, 4, 2, 320), torch.float32, i)
                  for i in range(3)))),
            (IndexError, lambda: ops.flash_decode(q[:, 0].contiguous(), k,
                                                  k, pos)),
            (ValueError, lambda: ops.flash_decode(q[:, 0], k, k, pos - 1)),
    ]:
        with pytest.raises(exc):
            call()
    assert (ops.rmsnorm.launches, ops.flash_attention.launches,
            ops.flash_decode.launches) == counts


def test_reduced_model_generates_the_cpu_tokens_on_the_card(cuda):
    """Reduced gemma2-2b in float32: prefill and decode through the
    three kernels on the card give the CPU's greedy tokens, and the
    launch counts follow the path: per forward 4 norms per layer + 1,
    per prefill one attention per layer, per decode step one decode
    attention per layer."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS["gemma2-2b"]).replace(dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    for p in cpu.parameters():
        if p.dim() == 1:                    # non-zero norm scales
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())) * 0.1)
    card = copy.deepcopy(cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    n = 8
    before = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    got = generate(cfg, ShardCtx(), card, {"tokens": prompt.to(cuda)}, n)
    layers = cfg.n_layers
    assert (ops.rmsnorm.launches - before[0],
            ops.flash_attention.launches - before[1],
            ops.flash_decode.launches - before[2]) == \
        (n * (4 * layers + 1), layers, (n - 1) * layers)
    want = generate(cfg, ShardCtx(), cpu, {"tokens": prompt}, n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_reduced_moe_model_generates_the_cpu_tokens_on_the_card(cuda, name):
    """Reduced deepseek (MLA) and qwen3 (GQA, qk-norm), MoE layers in
    both, in float32: the card gives the CPU's greedy tokens, and the
    counts follow the path: per forward 2 norms per layer, 1 more per
    MLA layer (``kv_norm``), 2 more per qk-norm layer and 1 final; one
    attention per layer per prefill; one decode attention per layer per
    decode step for GQA and none for MLA (its absorbed decode is plain
    PyTorch)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    for p in cpu.parameters():
        if p.dim() == 1:                    # non-zero norm scales
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())) * 0.1)
    card = copy.deepcopy(cpu).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    n = 8
    before = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.flash_decode.launches)
    got = generate(cfg, ShardCtx(), card, {"tokens": prompt.to(cuda)}, n)
    layers = cfg.n_layers
    norms = 2 + bool(cfg.kv_lora_rank) + 2 * cfg.qk_norm
    assert (ops.rmsnorm.launches - before[0],
            ops.flash_attention.launches - before[1],
            ops.flash_decode.launches - before[2]) == \
        (n * (norms * layers + 1), layers,
         0 if cfg.kv_lora_rank else (n - 1) * layers)
    want = generate(cfg, ShardCtx(), cpu, {"tokens": prompt}, n)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# ssd_scan: the Mamba-2 SSD chunked scan
# ---------------------------------------------------------------------------

def ssd_inputs(device, b, s, h, p, g, n, dtype, seed):
    """Mamba-2-like inputs made with NumPy: A in -[1, 16] and dt
    log-uniform in [1e-3, 1e-1] (the paper's init), so that the state
    carried across chunks is far from zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    A = -rng.uniform(1.0, 16.0, h)
    B = rng.standard_normal((b, s, g, n)) * 0.5
    C = rng.standard_normal((b, s, g, n)) * 0.5
    return [torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(dt).to(device, torch.float32),
            torch.from_numpy(A).to(device, torch.float32),
            torch.from_numpy(B).to(device, dtype),
            torch.from_numpy(C).to(device, dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (4, 512, 48, 64, 1, 128, 256),     # mamba2-780m, run A
    (1, 4000, 48, 64, 1, 128, 256),    # run B: 15 chunks + a ragged 160
    (2, 700, 112, 64, 1, 64, 256),     # zamba2-7b, run D
    (1, 37, 48, 64, 1, 128, 256),      # S < chunk
    (1, 1, 4, 64, 1, 128, 256),        # one position
    (2, 100, 8, 16, 2, 16, 8),         # reduced widths, two groups
    (3, 300, 6, 40, 3, 100, 96),       # P, N, chunk off the tile grid
    (1, 700, 48, 64, 1, 128, 256),     # run C's longest prompt
    (1, 200, 4, 64, 1, 128, 1),        # chunk 1
    (2, 300, 8, 64, 2, 64, 64),        # chunk 64, two groups, ragged
    (1, 1, 4, 64, 2, 64, 64),          # one position, two groups
])
def test_ssd_scan_kernel_close_to_plain_version(cuda, dtype, b, s, h, p, g,
                                                n, chunk):
    args = ssd_inputs(cuda, b, s, h, p, g, n, dtype, s + h)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk)
    assert ops.ssd_scan.launches == before + 1
    want_y, want_state = ssd_scan.ssd_scan_torch(*args, chunk)
    torch.cuda.synchronize()
    assert_close_to_plain(y, want_y)
    assert_close_to_plain(state, want_state)
    if s > chunk:                                            # a live carry
        assert float(want_state.float().abs().max()) > 0.1


def test_ssd_scan_refuses_bad_input_without_falling_back(cuda):
    x, dt, A, B, C = ssd_inputs(cuda, 1, 10, 4, 16, 2, 16, torch.float32, 0)
    wide = ssd_inputs(cuda, 1, 10, 4, 72, 1, 16, torch.float32, 1)
    deep = ssd_inputs(cuda, 1, 10, 4, 16, 1, 136, torch.float32, 2)
    before = ops.ssd_scan.launches
    for exc, call in [
            (ValueError, lambda: ops.ssd_scan(x, dt, A.cpu(), B, C)),
            (TypeError, lambda: ops.ssd_scan(x, dt, A, B.bfloat16(), C)),
            (TypeError, lambda: ops.ssd_scan(x, dt.double(), A, B, C)),
            (ValueError, lambda: ops.ssd_scan(x, dt, A, B, C, 0)),
            (ValueError, lambda: ops.ssd_scan(*wide)),
            (ValueError, lambda: ops.ssd_scan(*deep)),
            (ValueError, lambda: ops.ssd_scan(x, dt, A, B, C, 100_000)),
    ]:
        with pytest.raises(exc):
            call()
    assert ops.ssd_scan.launches == before


def test_shared_memory_need_of_a_block(cuda):
    """The library's own count: one block per SM at mamba2-780m's widths,
    two at zamba2-7b's; a chunk too long for a block is refused."""
    limit = ssd_scan._library().ssd_scan_max_shared_bytes()
    assert ssd_scan.shared_bytes(64, 128, 256) <= 136 * 1024   # mamba2-780m
    assert 2 * ssd_scan.shared_bytes(64, 64, 256) <= limit     # zamba2-7b
    assert ssd_scan.shared_bytes(64, 128, 20_000) > limit
    assert ssd_scan.refusal(64, 128, 256) is None
    assert "shared memory" in ssd_scan.refusal(64, 128, 20_000)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_reduced_ssm_model_generates_the_cpu_tokens_on_the_card(cuda, name):
    """Reduced mamba2-780m and zamba2-7b in float32 with Mamba-2's A and
    dt init and non-zero LoRA: prefill through ``ssd_scan`` (and, for
    zamba2, the shared block's attention) and decode on the card give the
    CPU's greedy tokens, and the launch counts follow the path: per
    forward 2 norms per Mamba layer, 2 per shared-block use and 1 final;
    per prefill one scan per Mamba layer and one attention per group;
    per decode step one decode attention per group."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for pname, p in cpu.named_parameters():
        leaf = pname.rsplit(".", 1)[-1]
        if leaf == "A_log":
            p.copy_(torch.from_numpy(np.log(rng.uniform(1.0, 16.0, p.shape))))
        elif leaf == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), p.shape))
            p.copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        elif leaf.startswith("b_"):          # the LoRA's zero-init half
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                     / np.sqrt(p.shape[0])))
        elif p.dim() == 1 and leaf != "D":   # non-zero norm scales
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * 0.1))
    card = copy.deepcopy(cpu).to(cuda)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 37)))
    n = 8
    counters = (ops.rmsnorm, ops.ssd_scan, ops.flash_attention,
                ops.flash_decode)
    before = [c.launches for c in counters]
    got = generate(cfg, ShardCtx(), card, {"tokens": prompt.to(cuda)}, n)
    _, n_rep, _, _ = cfg.repeat_structure()
    groups = n_rep if cfg.shared_attn_every else 0
    layers = cfg.n_layers
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [n * (2 * layers + 2 * groups + 1), layers, groups, (n - 1) * groups]
    want = generate(cfg, ShardCtx(), cpu, {"tokens": prompt}, n)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# sim_step / sim_relax (dense) and the device GA
# ---------------------------------------------------------------------------

def same_or_both_nan(got, want):
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("b,s", [(1, 1), (3, 37), (2, 1000), (4, 815),
                                 (1, 33)])
def test_sim_step_kernel_equals_plain_version(cuda, b, s):
    args = on(cuda, dense_inputs(b * 1000 + s, b, s))
    before = ops.sim_step.launches
    got = ops.sim_step(*args)
    assert ops.sim_step.launches == before + 1
    want = sim_step.sim_step_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        ref.sim_step_ref(*[x.cpu().numpy() for x in args]))


def test_sim_step_kernel_propagates_nan_and_inf_like_the_plain_version(cuda):
    end, lat, volbw, dur, rel = dense_inputs(3, 3, 1000)
    rng = np.random.default_rng(4)
    lat[rng.random(lat.shape) < 1e-4] = np.nan
    volbw[rng.random(volbw.shape) < 1e-4] = np.inf
    end[2, 17] = np.inf             # inf + -inf non-edges: NaN
    dur[0, :5] = np.nan
    rel[1, :5] = -np.inf
    args = on(cuda, (end, lat, volbw, dur, rel))
    got, want = ops.sim_step(*args), sim_step.sim_step_torch(*args)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())
    assert same_or_both_nan(got, want)


@pytest.mark.parametrize("kind", ["8core", "64core"])
def test_sim_relax_kernel_equals_plain_on_a_lowered_suite(cuda, kind):
    from repro_torch.core.lowering import dense_lags
    from repro_torch.core.sim_engine import relax_batch_np
    m = T.dell_poweredge_1950() if kind == "8core" else T.hp_bl260c()
    graphs = [T.generate_app(T.SynthParams(n_tasks=(30, 60)), seed=40 + i)
              for i in range(3)]
    batch = T.batch_scenarios([T.lower_scenario(g, m, T.engine_schedule(g, m))
                               for g in graphs])
    lat, volbw = dense_lags(batch)
    args = on(cuda, [np.ascontiguousarray(x, np.float32) for x in
                     (lat, volbw, batch.duration, batch.release)])
    for steps in (batch.depth // 3, batch.depth):
        before = ops.sim_relax.launches
        variants = dict(ops.sim_relax.variants)
        got = ops.sim_relax(*args, n_steps=steps)
        assert ops.sim_relax.launches == before + 1
        assert ops.sim_relax.variants == {
            "compact": variants["compact"] + 1, "dense": variants["dense"]}
        want = sim_step.sim_relax_torch(*args, n_steps=steps)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        _, info = sim_step.sim_relax_cuda(*args, n_steps=steps,
                                          with_info=True)
        comp = sim_step.compact_lags_torch(*args)
        _, sweeps = sim_step.fixpoint_sweeps_torch(*comp[:3], *args[2:],
                                                   n_steps=steps)
        assert torch.equal(info.sweeps, sweeps.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), relax_batch_np(batch),
                               rtol=1e-5, atol=0.0)
    got = sim_step.compact_lags_cuda(*args)
    want = sim_step.compact_lags_torch(*args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


def test_sim_relax_sends_nan_inf_and_overflow_to_the_dense_variant(cuda):
    """Four scenarios: clean (compact), NaN lags, +inf durations (both
    dense from the start) and one whose ends overflow (compact, flagged,
    redone dense); the result equals the plain version, NaN at the same
    places, and both variant counts move."""
    _, lat, volbw, dur, rel = dense_inputs(8, 4, 256, edge_frac=0.05)
    lat[1][np.argwhere(lat[1] > -np.inf)[0][0]] = np.nan
    dur[2, 3] = np.inf
    dur[3] = 2e37
    args = on(cuda, (lat, volbw, dur, rel))
    before = dict(ops.sim_relax.variants)
    got = ops.sim_relax(*args, n_steps=60)
    want = sim_step.sim_relax_torch(*args, n_steps=60)
    torch.cuda.synchronize()
    assert ops.sim_relax.variants == {k: v + 1 for k, v in before.items()}
    assert bool(torch.isnan(want[3]).any())
    assert same_or_both_nan(got, want)
    _, info = sim_step.sim_relax_cuda(*args, n_steps=60, with_info=True)
    assert info.compact.tolist() == [True, False, False, False]
    assert info.redone.tolist() == [False, False, False, True]


def test_dense_launch_geometry(cuda):
    """The end row staged in shared memory, as the library counts it:
    the size the guard checks on the card, refused past the limit."""
    limit = sim_step._dense_library().sim_step_max_shared_bytes()
    assert sim_step.dense_shared_bytes(815) == 3260
    assert sim_step.dense_shared_bytes(1235) == 4940
    assert sim_step.dense_shared_bytes(58_112) <= limit
    assert sim_step.dense_shared_bytes(58_113) > limit
    assert sim_step.dense_refusal(58_112) is None
    assert "shared memory" in sim_step.dense_refusal(58_113)


def test_dense_kernels_refuse_bad_input_without_falling_back(cuda):
    end, lat, volbw, dur, rel = on(cuda, dense_inputs(1, 2, 40))
    with pytest.raises(ValueError, match="several devices"):
        ops.sim_step(end, lat, volbw, dur.cpu(), rel)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sim_relax(lat.transpose(1, 2), volbw, dur, rel, n_steps=2)
    with pytest.raises(TypeError):
        ops.sim_relax(lat.double(), volbw, dur, rel, n_steps=2)
    before = ops.sim_relax.launches
    assert torch.equal(ops.sim_relax(lat, volbw, dur, rel, n_steps=0),
                       torch.zeros_like(dur))
    assert ops.sim_relax.launches == before


def test_device_ga_on_the_card(cuda):
    """Kernel fitness equals the scan's under ``torch.equal`` on the card;
    the search is deterministic under its seed, launches the kernel once
    per fitness call, and ``ga <= engine`` holds."""
    from repro_torch.search import GAParams, ga_schedule, ga_search
    from repro_torch.search import device as D
    m = T.hp_bl260c()
    g = T.generate_app(T.SynthParams(n_tasks=(40, 60)), seed=31)
    inp = D.device_inputs(g, m, device=cuda)
    pop = torch.from_numpy(np.random.default_rng(0).integers(
        0, m.n_cores, (16, len(g.tasks)), dtype=np.int32)).to(cuda)
    kern = D.population_fitness_device(inp, pop, method="kernel")
    scan = D.population_fitness_device(inp, pop, method="scan")
    torch.cuda.synchronize()
    assert torch.equal(kern, scan)
    cpu = D.population_fitness_device(D.device_inputs(g, m, device="cpu"),
                                      pop.cpu(), method="scan")
    assert torch.equal(kern.cpu(), cpu)
    par = GAParams(pop_size=12, generations=4, refine_rounds=0, device=True)
    before = ops.sim_relax_pop.launches
    v1, f1 = ga_search(g, m, seed=3, params=par)
    assert ops.sim_relax_pop.launches == before + 1 + par.generations
    v2, f2 = ga_search(g, m, seed=3, params=par)
    assert np.array_equal(v1, v2) and f1 == f2
    eng = T.get_scheduler("engine")(g, m)
    sch = ga_schedule(g, m, seed=0, params=par)
    T.validate(sch, g, m, require_task_coherence=True)
    assert sch.makespan() <= eng.makespan() + 1e-9


def test_simulate_suite_verify_on_the_card(cuda):
    m = T.hp_bl260c()
    graphs = [T.generate_app(T.SynthParams(n_tasks=(60, 90)), seed=60 + i)
              for i in range(2)]
    scheds = [T.engine_schedule(g, m) for g in graphs]
    T.simulate_suite(graphs, m, scheds, jitter=0.01, verify=True,
                     device=cuda)


# ---------------------------------------------------------------------------
# the training path: flash_attention's prefix mask, lse and backward;
# rmsnorm's backward
# ---------------------------------------------------------------------------

def assert_lse_close(got, want):
    """float32 lse of both kernels against the plain version's: the
    scores are float32 in both, so within 1e-5 of max(1, |lse|)."""
    err = (got.double() - want.double()).abs()
    bound = 1e-5 * torch.clamp(want.double().abs(), min=1.0)
    assert bool((err <= bound).all()), f"lse max abs err {float(err.max())}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,prefix,softcap", [
    (1, 768, 8, 1, 256, (256,), None),          # paligemma-3b's prefill
    (2, 300, 4, 1, 64, (0, 100), 30.0),         # a prefix inside a tile
    (2, 200, 4, 2, 128, (64, 300), None),       # a tile edge; past S
    (3, 77, 4, 2, 80, (1, 13, 77), 50.0),       # ragged, D 80
])
def test_flash_attention_prefix_and_lse_close_to_plain(
        cuda, dtype, b, s, hq, hkv, d, prefix, softcap):
    q = rand(cuda, (b, s, hq, d), dtype, 31)
    k = rand(cuda, (b, s, hkv, d), dtype, 32)
    v = rand(cuda, (b, s, hkv, d), dtype, 33)
    pre = torch.tensor(prefix, dtype=torch.int32, device=cuda)
    before = ops.flash_attention.launches
    got, lse = ops.flash_attention(q, k, v, softcap=softcap, prefix_len=pre,
                                   return_lse=True)
    plain = ops.flash_attention(q, k, v, softcap=softcap, prefix_len=pre)
    assert ops.flash_attention.launches == before + 2
    assert torch.equal(got, plain)              # lse costs nothing in out
    want, want_lse = flash_attention.flash_attention_torch(
        q, k, v, softcap=softcap, prefix_len=pre, return_lse=True)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)
    assert_lse_close(lse, want_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bidirectional_at_hubert_shape(cuda, dtype):
    q, k, v = (rand(cuda, (2, 1000, 16, 80), dtype, 40 + i)
               for i in range(3))
    got, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
    want, want_lse = flash_attention.flash_attention_torch(
        q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want)
    assert_lse_close(lse, want_lse)


BWD_CASES = [   # b, s, hq, hkv, d, dv, causal, window, softcap, prefix
    (2, 256, 8, 4, 256, 256, True, None, 50.0, None),    # gemma2 global
    (2, 256, 8, 4, 256, 256, True, 100, 50.0, None),     # gemma2 local
    (1, 300, 8, 1, 256, 256, True, None, None, (100,)),  # paligemma
    (2, 120, 16, 16, 80, 80, False, None, None, None),   # hubert
    (1, 200, 16, 16, 192, 128, True, None, None, None),  # MLA
    (3, 37, 4, 2, 16, 16, True, 8, 5.0, (0, 5, 50)),     # everything, ragged
    (1, 1024, 8, 1, 256, 256, True, None, None, (256,)),  # G = 8 split
    (2, 333, 4, 2, 72, 72, True, 50, 30.0, None),        # ragged, D % 16 = 8
    (2, 1000, 16, 16, 80, 80, False, None, None, None),  # hubert, full
]


def bwd_inputs(cuda, dtype, b, s, hq, hkv, d, dv, prefix, seed=50):
    q = rand(cuda, (b, s, hq, d), dtype, seed)
    k = rand(cuda, (b, s, hkv, d), dtype, seed + 1)
    v = rand(cuda, (b, s, hkv, dv), dtype, seed + 2)
    dout = rand(cuda, (b, s, hq, dv), dtype, seed + 3)
    pre = None if prefix is None else \
        torch.tensor(prefix, dtype=torch.int32, device=cuda)
    return q, k, v, dout, pre


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,dv,causal,window,softcap,prefix",
                         BWD_CASES)
def test_flash_attention_bwd_kernel_close_to_plain_version(
        cuda, dtype, b, s, hq, hkv, d, dv, causal, window, softcap, prefix):
    """dq, dk, dv of the backward kernels against the plain backward on
    the same (out, lse) from the kernel forward, within
    ``assert_close_to_plain`` (both compute in float32 and round once);
    one launch counted; two launches equal bit for bit."""
    q, k, v, dout, pre = bwd_inputs(cuda, dtype, b, s, hq, hkv, d, dv,
                                    prefix)
    kw = dict(causal=causal, window=window, softcap=softcap, prefix_len=pre,
              scale=d ** -0.5)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert ops.flash_attention_bwd.launches == before + 1
    want = flash_attention.flash_attention_bwd_torch(q, k, v, out, dout, lse,
                                                     **kw)
    again = ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        assert_close_to_plain(g, w)
        assert torch.equal(g, a)


def plain_gate(want):
    """``assert_close_to_plain``'s bound on each element's error."""
    w = want.double()
    amax = float(w.abs().max()) if w.numel() else 0.0
    if want.dtype == torch.float32:
        return 1e-5 * w.abs() + 1e-5 * amax
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    return 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,dv,causal,window,softcap,prefix",
                         BWD_CASES)
def test_flash_attention_offset_chunks_close_to_plain_and_whole(
        cuda, dtype, b, s, hq, hkv, d, dv, causal, window, softcap, prefix):
    """Both kernels on 4 query chunks (the last ragged where S does not
    split) at their ``q_offset`` against the whole K/V: each chunk's
    out, lse, dq, dk, dv against the plain versions on the chunk; out,
    lse and dq against the whole-sequence kernels' rows; the chunks' dk
    and dv summed within the sum of the five gates of the whole's."""
    q, k, v, dout, pre = bwd_inputs(cuda, dtype, b, s, hq, hkv, d, dv,
                                    prefix)
    kw = dict(causal=causal, window=window, softcap=softcap, prefix_len=pre,
              scale=d ** -0.5)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    dq, dk, dv_ = ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    sums = [torch.zeros(t.shape, dtype=torch.float64, device=cuda)
            for t in (dk, dv_)]
    gates = [plain_gate(dk), plain_gate(dv_)]
    n = -(-s // 4)
    for off in range(0, s, n):
        rows = slice(off, min(s, off + n))
        qc, doc = q[:, rows].contiguous(), dout[:, rows].contiguous()
        oc, lc = ops.flash_attention(qc, k, v, return_lse=True,
                                     q_offset=off, **kw)
        g = ops.flash_attention_bwd(qc, k, v, oc, doc, lc, q_offset=off,
                                    **kw)
        po, pl = flash_attention.flash_attention_torch(
            qc, k, v, return_lse=True, q_offset=off, **kw)
        pg = flash_attention.flash_attention_bwd_torch(
            qc, k, v, oc, doc, lc, q_offset=off, **kw)
        torch.cuda.synchronize()
        assert_close_to_plain(oc, po)
        assert_lse_close(lc, pl)
        for got, want in zip(g, pg):
            assert_close_to_plain(got, want)
        assert_close_to_plain(oc, out[:, rows].contiguous())
        assert_lse_close(lc, lse[:, :, rows].contiguous())
        assert_close_to_plain(g[0], dq[:, rows].contiguous())
        for i in (0, 1):
            sums[i] += g[1 + i].double()
            gates[i] += plain_gate(g[1 + i])
    for got, want, gate in zip(sums, (dk, dv_), gates):
        err = (got - want.double()).abs()
        assert bool((err <= gate).all()), f"max abs err {float(err.max())}"


def test_flash_attention_bwd_plan_on_the_card(cuda):
    """The bf16 launch plan splits the dK/dV blocks at the paligemma
    case of ``BWD_CASES`` (so the fixed-order sum of the partials ran
    there) and not at hubert's; its shared-memory sizes are the
    library's own, within what a block may use."""
    lib = flash_attention._bwd_library()
    assert flash_attention.bwd_plan(1, 1024, 8, 1, 256, 256)[:2] == (8, 2)
    assert flash_attention.bwd_plan(2, 1000, 16, 16, 80, 80)[:2] == (1, 1)
    for d, dv in ((256, 256), (80, 80), (192, 128), (72, 72), (16, 16),
                  (8, 8)):
        for kv in (True, False):
            want = lib.flash_attention_bwd_shared_bytes(d, dv, int(kv))
            assert flash_attention.bwd_shared_bytes(d, dv, kv) == want
            assert want <= 232448


def test_flash_attention_bwd_refuses_what_the_forward_refuses(cuda):
    """bfloat16 head dims that are not multiples of 8 or q, k, v not
    16-byte aligned: the forward's refusal (a ValueError naming the TMA
    loads), and a dout not 16-byte aligned: a ValueError of its own, each
    before anything launches; float32 takes the odd head dim."""
    def args(d, dtype, offset=0):
        flat = rand(cuda, (5 * 2 * 40 * 4 * d + offset,), dtype, 21)
        q, k, v, out, dout = (flat[offset + i * 320 * d:
                                   offset + (i + 1) * 320 * d]
                              .view(2, 40, 4, d) for i in range(5))
        lse = torch.zeros((2, 4, 40), dtype=torch.float32, device=cuda)
        return q, k, v, out, dout, lse
    counts = ops.flash_attention_bwd.launches
    for a in (args(20, torch.bfloat16), args(64, torch.bfloat16, 1)):
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention_bwd(*a)
    assert ops.flash_attention_bwd.launches == counts
    q, k, v, _, _, _ = args(64, torch.bfloat16)
    flat = rand(cuda, (320 * 64 + 1,), torch.bfloat16, 22)
    dout = flat[1:].view(2, 40, 4, 64)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="dout not 16-byte aligned"):
        ops.flash_attention_bwd(q, k, v, out, dout, lse)
    assert ops.flash_attention_bwd.launches == counts
    q, k, v, _, dout, _ = args(20, torch.float32)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse)
    want = flash_attention.flash_attention_bwd_torch(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert_close_to_plain(g, w)
    assert ops.flash_attention_bwd.launches == counts + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_of_one_token(cuda, dtype):
    """S = 1: the one key has P = 1, so out = v and dS = dP - delta = 0
    exactly; dq and dk are float32 cancellation noise in both versions
    (about 1e-8 against terms of |dout| |v| ~ 10), so they are held to
    that scale, and dv = dout to the plain version."""
    q, k, v, dout, _ = bwd_inputs(cuda, dtype, 1, 1, 2, 1, 32, 32, None)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, dout, lse)
    want = flash_attention.flash_attention_bwd_torch(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    terms = float(dout.float().abs().max() * v.float().abs().max()) * 32
    for g in (dq, dk):
        assert float(g.float().abs().max()) <= 1e-5 * terms
    assert_close_to_plain(dv, want[2])


def test_attention_autograd_runs_the_backward_kernel(cuda):
    """``layers.attention`` on tensors that need a gradient: the forward
    kernel once (with lse), the backward kernel once, and the gradients
    of the plain path within float32's tolerance."""
    from repro_torch.models.layers import attention
    q, k, v, dout, pre = bwd_inputs(cuda, torch.float32, 2, 150, 4, 2, 64,
                                    64, (40, 0))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = attention(*leaves, attn_softcap=30.0, prefix_len=pre)
    (out * dout).sum().backward()
    assert (ops.flash_attention.launches - before[0],
            ops.flash_attention_bwd.launches - before[1]) == (1, 1)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_out, ref_lse = flash_attention.flash_attention_torch(
        *plain, softcap=30.0, prefix_len=pre, return_lse=True)
    want = flash_attention.flash_attention_bwd_torch(
        q, k, v, ref_out.detach(), dout, ref_lse, softcap=30.0,
        prefix_len=pre)
    torch.cuda.synchronize()
    for x, w in zip(leaves, want):
        assert_close_to_plain(x.grad, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wdtype,zero_centered", [
    ((2, 1024, 2304), None, False),              # gemma2-2b's d
    ((2, 1000, 16, 80), torch.float32, True),   # qk-norm-like rows
    ((3, 1001), None, True), ((1, 16), torch.bfloat16, False),
    ((300, 7168), None, False)])
def test_rmsnorm_bwd_kernel_close_to_plain_version(cuda, dtype, shape, wdtype,
                                                   zero_centered):
    """dx within ``assert_close_to_plain``; dw, a sum over every row, in
    float32 within 1e-5 of its largest entry x max(1, sqrt(rows) / 10)
    (the plain version sums the rows in another order; chip_smoke.py's
    bound) and in bfloat16 within 2 ulps; two launches equal bit for
    bit."""
    x = rand(cuda, shape, dtype, 61)
    w = rand(cuda, shape[-1:], wdtype or dtype, 62, 0.1)
    dy = rand(cuda, shape, dtype, 63)
    before = ops.rmsnorm_bwd.launches
    dx, dw = ops.rmsnorm_bwd(x, w, dy, zero_centered=zero_centered)
    assert ops.rmsnorm_bwd.launches == before + 1
    want_dx, want_dw = rmsnorm.rmsnorm_bwd_torch(x, w, dy,
                                                 zero_centered=zero_centered)
    dx2, dw2 = ops.rmsnorm_bwd(x, w, dy, zero_centered=zero_centered)
    torch.cuda.synchronize()
    assert_close_to_plain(dx, want_dx)
    assert dw.dtype == w.dtype and dw.shape == w.shape
    if dw.dtype == torch.float32:
        rows = x.numel() // x.shape[-1]
        err = float((dw - want_dw).abs().max())
        assert err <= 1e-5 * float(want_dw.abs().max()) * max(
            1.0, rows ** 0.5 / 10)
    else:
        assert_close_to_plain(dw, want_dw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1280, 1536, 2048, 2304, 3072, 3584, 7168])
def test_rmsnorm_bwd_at_the_training_widths(cuda, dtype, d):
    """The seven widths the training paths launch (hubert, mamba2 and
    its d_inner, paligemma, gemma2, zamba2 and its shared block's 2d)
    at (2, 1024, d): the vector path (threads per row by width, blocks
    that fill the card), within the gates of
    ``test_rmsnorm_bwd_kernel_close_to_plain_version``, two launches
    equal bit for bit."""
    x = rand(cuda, (2, 1024, d), dtype, 71)
    w = rand(cuda, (d,), dtype, 72, 0.1)
    dy = rand(cuda, (2, 1024, d), dtype, 73)
    threads, blocks = rmsnorm.bwd_plan(2048, d, dtype, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert threads == rmsnorm.row_threads(d, dtype) and 32 <= threads <= 512
    assert sms <= blocks <= 8 * sms
    dx, dw = ops.rmsnorm_bwd(x, w, dy, zero_centered=False)
    want_dx, want_dw = rmsnorm.rmsnorm_bwd_torch(x, w, dy,
                                                 zero_centered=False)
    dx2, dw2 = ops.rmsnorm_bwd(x, w, dy, zero_centered=False)
    torch.cuda.synchronize()
    assert_close_to_plain(dx, want_dx)
    if dtype == torch.float32:
        err = float((dw - want_dw).abs().max())
        assert err <= 1e-5 * float(want_dw.abs().max()) * max(
            1.0, 2048 ** 0.5 / 10)
    else:
        assert_close_to_plain(dw, want_dw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def test_rmsnorm_bwd_scalar_path_for_unaligned_rows(cuda):
    """A tensor that starts off the 16-byte grid takes the scalar path
    (threads per row 0, at most 256 blocks) and gives what the plain
    version gives."""
    base = rand(cuda, (2 * 333 * 2304 + 1,), torch.bfloat16, 74)
    x = base[1:].view(2, 333, 2304)
    w = rand(cuda, (2304,), torch.bfloat16, 75, 0.1)
    dy = rand(cuda, (2, 333, 2304), torch.bfloat16, 76)
    assert rmsnorm.bwd_plan(666, 2304, torch.bfloat16, torch.bfloat16,
                            aligned=False) == (0, 256)
    dx, dw = ops.rmsnorm_bwd(x, w, dy, zero_centered=True)
    want_dx, want_dw = rmsnorm.rmsnorm_bwd_torch(x, w, dy)
    torch.cuda.synchronize()
    assert_close_to_plain(dx, want_dx)
    assert_close_to_plain(dw, want_dw)


def ssd_grads(device, b, s, h, p, n, dtype, seed, with_final):
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p))).to(device,
                                                                dtype)
    dfinal = torch.from_numpy(rng.standard_normal((b, h, p, n))).to(
        device, dtype) if with_final else None
    return dy, dfinal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,with_final", [
    (2, 1024, 48, 64, 1, 128, 256, False),   # mamba2-780m training
    (2, 1024, 112, 64, 1, 64, 256, False),   # zamba2-7b training
    (1, 700, 48, 64, 1, 128, 256, True),     # ragged, the final state's grad
    (2, 100, 8, 16, 2, 16, 8, True),         # reduced widths, two groups
    (3, 300, 6, 40, 3, 100, 96, True),       # P, N, chunk off the tile grid
    (1, 1, 4, 64, 1, 128, 256, True),        # one position
    (1, 50, 4, 64, 2, 64, 1, False),         # chunk 1
    (1, 700, 112, 64, 1, 64, 256, True),     # zamba2-like, ragged, dfinal
    (2, 300, 16, 64, 4, 128, 256, True),     # 4 heads a group, 4 groups
])
def test_ssd_scan_bwd_kernel_close_to_plain_version(cuda, dtype, b, s, h, p,
                                                    g, n, chunk, with_final):
    """Every gradient within ``assert_close_to_plain`` of
    ``ssd_scan_bwd_torch`` on the same tensors (bf16 outputs within 2
    ulps, float32 ones within 1e-5 relative plus 1e-5 of the largest),
    one count per call, two launches equal bit for bit."""
    args = ssd_inputs(cuda, b, s, h, p, g, n, dtype, s + h + 1)
    dy, dfinal = ssd_grads(cuda, b, s, h, p, n, dtype, s + h + 2,
                           with_final)
    before = ops.ssd_scan_bwd.launches
    got = ops.ssd_scan_bwd(*args, dy, dfinal, chunk)
    assert ops.ssd_scan_bwd.launches == before + 1
    again = ops.ssd_scan_bwd(*args, dy, dfinal, chunk)
    want = ssd_scan.ssd_scan_bwd_torch(*args, dy, dfinal, chunk)
    torch.cuda.synchronize()
    for gt, g2, wt in zip(got, again, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        assert_close_to_plain(gt, wt)
        assert torch.equal(gt, g2)


def test_ssd_scan_bwd_workspace_at_mamba2_training_shape(cuda):
    """The backward's scratch at mamba2-780m's training call (2, 1024, 48,
    64), N 128, chunk 256, bf16, stays at most 40 MB (the design with
    per-head float32 dB and dC rows took 127.8 MB)."""
    need = ssd_scan.bwd_workspace_bytes(2, 1024, 48, 64, 1, 128, 256,
                                        torch.bfloat16)
    assert 0 < need <= 40e6, need


def test_ssd_scan_bwd_refuses_bad_input_without_falling_back(cuda):
    x, dt, A, B, C = ssd_inputs(cuda, 1, 10, 4, 16, 2, 16, torch.float32, 0)
    dy = torch.zeros_like(x)
    wide = ssd_inputs(cuda, 1, 10, 4, 72, 1, 16, torch.float32, 1)
    before = ops.ssd_scan_bwd.launches
    for exc, call in [
            (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy.cpu())),
            (TypeError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C,
                                                 dy.bfloat16())),
            (ValueError, lambda: ops.ssd_scan_bwd(
                *wide, torch.zeros_like(wide[0]))),
            (ValueError, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy, None,
                                                  100_000)),
    ]:
        with pytest.raises(exc):
            call()
    assert ops.ssd_scan_bwd.launches == before
    assert ssd_scan.bwd_refusal(64, 128, 256) is None
    assert "shared memory" in ssd_scan.bwd_refusal(64, 128, 20_000)


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_reduced_ssm_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One float32 ``make_train_step`` of reduced mamba2-780m and
    zamba2-7b (remat full) on the card against the CPU's: the loss and
    every new parameter within 1e-4 of the largest; the scan's forward
    twice and its backward once per Mamba layer."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.models import ShardCtx
    from repro_torch.optim import OptConfig
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[name]).replace(dtype="float32", remat="full")
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
    cpu = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    card = {"params": copy.deepcopy(cpu["params"]).to(cuda),
            "opt": {k: ({n: t.to(cuda) for n, t in v.items()}
                        if isinstance(v, dict) else v.to(cuda))
                    for k, v in cpu["opt"].items()}}
    pipe = TokenPipeline(cfg, PipelineConfig(batch=2, seq_len=40))
    step = make_train_step(cfg, opt, ShardCtx())
    n_mamba = sum(k == "ssm" for k in cfg.layer_kinds())
    before = (ops.ssd_scan.launches, ops.ssd_scan_bwd.launches)
    card, got = step(card, {k: v.to(cuda)
                            for k, v in pipe.make_batch(0).items()})
    assert (ops.ssd_scan.launches - before[0],
            ops.ssd_scan_bwd.launches - before[1]) == (2 * n_mamba, n_mamba)
    cpu, want = step(cpu, pipe.make_batch(0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for (k, a), (_, b) in zip(card["params"].named_parameters(),
                              cpu["params"].named_parameters()):
        err = float((a.detach().cpu() - b.detach()).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, k, err)


@contextlib.contextmanager
def routes(forced=None):
    """Every ``router_topk`` call's ids in call order (the forward's, then
    the recomputation's under remat); with ``forced`` (another run's
    ids) call i takes ``forced[i]`` instead of its own top-k, weighted as
    ``router_topk`` weights its own (``moe.route_weights``)."""
    from repro_torch.models import moe
    calls, real = [], moe.router_topk

    def router_topk(x, w_router, top_k):
        if forced is None:
            out = real(x, w_router, top_k)
        else:
            ids = forced[len(calls)].to(x.device)
            w, aux = moe.route_weights(moe.router_probs(x, w_router), ids)
            out = (w, ids, aux)
        calls.append(out[1])
        return out
    moe.router_topk = router_topk
    try:
        yield calls
    finally:
        moe.router_topk = real


@pytest.mark.parametrize("name", ["gemma2-2b", "paligemma-3b",
                                  "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One float32 ``make_train_step`` of reduced gemma2-2b (softcaps,
    windowed layers), paligemma-3b (the prefix), deepseek-v2-lite-16b
    (MLA: head dims 24/16, ``kv_norm``; a dense layer and MoE layers) and
    qwen3-moe-235b-a22b (GQA, qk-norm over rows of the head dim) on the
    card against the CPU's: the loss and every new parameter within 1e-4
    of the largest; both backward kernels launched, once per attention
    layer and once per norm of the forward, AdamW's two multi-tensor
    kernels once each over every parameter. The MoE models run under
    remat full, their router twice a layer (the forward and its
    recomputation), and the CPU replays the card's routes call by call,
    so a near tie in the top-k cannot send a token elsewhere."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.models import ShardCtx
    from repro_torch.optim import OptConfig
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = ARCHS[name].family == "moe"
    cfg = reduced(ARCHS[name]).replace(dtype="float32",
                                       remat="full" if moe else "none")
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-3)
    cpu = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    card = {"params": copy.deepcopy(cpu["params"]).to(cuda),
            "opt": {k: ({n: t.to(cuda) for n, t in v.items()}
                        if isinstance(v, dict) else v.to(cuda))
                    for k, v in cpu["opt"].items()}}
    pipe = TokenPipeline(cfg, PipelineConfig(batch=2, seq_len=40))
    step = make_train_step(cfg, opt, ShardCtx())
    before = (ops.flash_attention_bwd.launches, ops.rmsnorm_bwd.launches)
    opt_before = (ops.grad_sumsq.launches, ops.adamw_update.launches,
                  ops.adamw_update.tensors)
    with routes() as card_routes:
        card, got = step(card, {k: v.to(cuda)
                                for k, v in pipe.make_batch(0).items()})
    # AdamW's two multi-tensor calls took every parameter
    n_params = len(list(card["params"].parameters()))
    assert (ops.grad_sumsq.launches - opt_before[0],
            ops.adamw_update.launches - opt_before[1],
            ops.adamw_update.tensors - opt_before[2]) == (1, 1, n_params)
    per_layer = 2 + 2 * cfg.post_block_norms + 2 * cfg.qk_norm \
        + bool(cfg.kv_lora_rank)
    assert (ops.flash_attention_bwd.launches - before[0],
            ops.rmsnorm_bwd.launches - before[1]) == \
        (cfg.n_layers, cfg.n_layers * per_layer + 1)
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
    assert len(card_routes) == 2 * n_moe and (n_moe > 0) == moe
    with routes([r.cpu() for r in card_routes]) as cpu_routes:
        cpu, want = step(cpu, pipe.make_batch(0))
    assert len(cpu_routes) == len(card_routes)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["aux_loss"]),
                               float(want["aux_loss"]), rtol=1e-5)
    for (k, a), (_, b) in zip(card["params"].named_parameters(),
                              cpu["params"].named_parameters()):
        err = float((a.detach().cpu() - b.detach()).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, k, err)


# ---------------------------------------------------------------------------
# the expert-parallel dispatches and the pipeline on a one-rank NCCL group
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_rank(cuda):
    """A one-rank NCCL process group (a ``HashStore``), destroyed after
    the test."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield cuda
    dist.destroy_process_group()


def test_one_rank_nccl_moe_dispatches_equal_dense(nccl_rank):
    """Reduced qwen3-moe's first MoE layer in bf16 on a (1, 1) mesh:
    ``moe_a2a`` with the capacity raised so nothing drops within 2e-2 of
    the dense dispatch's largest output (the routed copies' products in
    another order and weighted in bf16, as the reference's); the local
    decode equal to the dense one bit for bit (at ep = 1 it runs the same
    products over every expert)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, moe
    cfg = reduced(ARCHS["qwen3-moe-235b-a22b"]).replace(dtype="bfloat16")
    dev = nccl_rank
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_params(cfg, gen, dev).layers[0].moe
    mesh = make_mesh((1, 1), ("data", "model"))
    kw = dict(top_k=cfg.top_k, activation=cfg.activation,
              n_experts=cfg.n_experts, mesh=mesh, dp_axes=("data",),
              ep_axis="model")
    x = torch.randn((2, 16, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    y, aux = moe.moe_a2a(x, p.router, p.wi, p.wo, capacity_factor=float(
        cfg.n_experts), **kw)
    want, want_aux = moe.moe_dense(x, p.router, p.wi, p.wo, cfg.top_k,
                                   cfg.activation)
    err = float((y.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max()), err
    assert torch.allclose(aux, want_aux, rtol=1e-5)
    xd = x[:, :1].contiguous()
    y, _ = moe.moe_local_decode(xd, p.router, p.wi, p.wo, **kw)
    assert torch.equal(y, moe.moe_dense(xd, p.router, p.wi, p.wo, cfg.top_k,
                                        cfg.activation)[0])


def test_one_stage_gpipe_equals_per_microbatch_forward(nccl_rank):
    """Reduced gemma2-2b in bf16 through ``make_pipelined_forward`` on a
    one-rank pod axis: the logits equal the per-microbatch ``forward``'s
    bit for bit."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, forward, init_params
    from repro_torch.runtime.pipeline import make_pipelined_forward
    cfg = reduced(ARCHS["gemma2-2b"]).replace(dtype="bfloat16")
    dev = nccl_rank
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab, (3, 2, 32), generator=gen,
                           device=dev)
    fwd = make_pipelined_forward(cfg, make_mesh((1,), ("pod",)), 1)
    with torch.no_grad():
        got = fwd(model, tokens)
        want = torch.stack([forward(model, {"tokens": t}, cfg,
                                    ShardCtx(mode="train"))[0]
                            for t in tokens])
    assert torch.equal(got, want)


def test_cuda_tensor_under_a_gloo_mesh_raises(cuda):
    """No silent move: a CUDA tensor under a CPU (gloo) mesh raises in
    the placement and in the dispatch; a mesh larger than the world
    raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import Spec, shard
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with pytest.raises(ValueError, match="cuda tensor under a cpu"):
            shard(torch.ones(4, device=cuda), Spec("model"), mesh)
        x = torch.ones((1, 2, 8), device=cuda)
        with pytest.raises(ValueError, match="cuda tensor under a cpu"):
            moe.moe_a2a(x, torch.ones((8, 2), device=cuda),
                        torch.ones((2, 8, 2, 4), device=cuda),
                        torch.ones((2, 4, 8), device=cuda), top_k=1,
                        activation="swiglu", n_experts=2,
                        capacity_factor=1.0, mesh=mesh, dp_axes=("data",),
                        ep_axis="model")
        with pytest.raises(RuntimeError, match="need 2 ranks, have 1"):
            make_mesh((2,), ("model",), device_type="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# AdamW: the multi-tensor update and the gradients' sums of squares
# ---------------------------------------------------------------------------

ADAMW_CONSTS = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def bench_shapes(name):
    """(shape, dtype) of each parameter of a benchmark cell's model, from
    the port's config on the meta device: ``zamba2`` (39 layers, 581
    tensors, 117 of them float32) or ``deepseek`` (6 layers, 72)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import init_params
    cfg = {"zamba2": ARCHS["zamba2-7b"].replace(
               n_layers=39, ssm_ngroups=2, activation="geglu",
               dtype="bfloat16"),
           "deepseek": ARCHS["deepseek-v2-lite-16b"].replace(
               n_layers=6, dtype="bfloat16")}[name]
    model = init_params(cfg, torch.Generator(), "meta")
    return [(tuple(p.shape), p.dtype) for _, p in model.named_parameters()]


def placed(x, misaligned):
    """``x``, or a contiguous copy of it one element past a 16-byte
    boundary (the kernels' scalar path)."""
    if not misaligned:
        return x
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def adamw_lists(device, specs, seed=0, grad_dtype=None, misaligned=()):
    """[params, grads, ms, vs] for ``specs`` ((shape, dtype) a tensor),
    drawn from ``seed`` on the card: parameters N(0, 1), gradients N(0,
    1e-2²) in ``grad_dtype`` (default the parameter's), m N(0, 1e-3²), v
    uniform in [0, 1e-5); tensors whose index is in ``misaligned`` off
    16 bytes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lists = [[], [], [], []]
    for i, (shape, dtype) in enumerate(specs):
        def draw(scale, dt, uniform=False):
            fn = torch.rand if uniform else torch.randn
            x = fn(shape, generator=gen, device=device) * scale
            return placed(x.to(dt), i in misaligned)
        lists[0].append(draw(1.0, dtype))
        lists[1].append(draw(1e-2, grad_dtype or dtype))
        lists[2].append(draw(1e-3, torch.float32))
        lists[3].append(draw(1e-5, torch.float32, uniform=True))
    return lists


def adamw_scalars(device, step=3, clip=0.37, lr=1e-2):
    """clip, lr and the bias corrections at ``step`` as
    ``apply_updates`` forms them: float32 scalars on the card. At lr 1e-2
    a step moves a parameter about one bf16 step, so the cast's rounding
    is exercised on most elements."""
    stepf = torch.tensor(float(step), device=device)
    b = {k: 1.0 - torch.pow(torch.tensor(ADAMW_CONSTS[k], device=device),
                            stepf) for k in ("b1", "b2")}
    return dict(clip=torch.tensor(clip, device=device),
                lr=torch.tensor(lr, device=device), b1c=b["b1"],
                b2c=b["b2"])


def bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def assert_update_bit_for_bit(device, specs, **kw):
    """The kernel's p, m and v bit for bit the plain version's on the
    card, from the same inputs and scalars; one launch for the list."""
    from repro_torch.kernels import adamw
    scalars = adamw_scalars(device)
    kern, plain = adamw_lists(device, specs, **kw), adamw_lists(device, specs,
                                                                **kw)
    before = (ops.adamw_update.launches, ops.adamw_update.tensors)
    versions = [x._version for i in (0, 2, 3) for x in kern[i]]
    ops.adamw_update(*kern, **scalars, **ADAMW_CONSTS)
    assert (ops.adamw_update.launches - before[0],
            ops.adamw_update.tensors - before[1]) == (1, len(specs))
    # written in place, so autograd sees each p, m and v as modified
    assert all(x._version > v for x, v in
               zip((x for i in (0, 2, 3) for x in kern[i]), versions))
    adamw.adamw_update_torch(*plain, **scalars, **ADAMW_CONSTS)
    torch.cuda.synchronize()
    for what, i in (("p", 0), ("m", 2), ("v", 3)):
        for j, (a, b) in enumerate(zip(kern[i], plain[i])):
            same = bits(a) == bits(b)
            assert bool(same.all()), (what, j, specs[j],
                                      int((~same).sum()))
    start = adamw_lists(device, specs, **kw)
    for i in (2, 3):                          # every tensor's moments moved
        assert not any(torch.equal(a, b) for a, b in zip(kern[i], start[i])
                       if a.numel())


@pytest.mark.parametrize("grad_dtype", [None, torch.float32])
def test_adamw_update_bit_for_bit_over_zamba2s_shapes(cuda, grad_dtype):
    """zamba2's 581 parameter shapes, each dim cut by 9 (394 numels off a
    multiple of 8), bf16 and float32 parameters as the model has them,
    every fifth tensor off 16 bytes; gradients of the parameter's type or
    float32 (int8 compression's)."""
    specs = [(tuple(max(1, d // 9) for d in s), dt)
             for s, dt in bench_shapes("zamba2")]
    assert len(specs) == 581
    assert_update_bit_for_bit(cuda, specs, grad_dtype=grad_dtype,
                              misaligned=set(range(0, len(specs), 5)))


def test_adamw_update_bit_for_bit_at_deepseeks_largest_leaf(cuda):
    """``layers.1.moe.wi`` (64, 2048, 2, 1408), 369 M elements, 5,632
    chunks, beside a float32 router and a ragged tail."""
    specs = [((64, 2048, 2, 1408), torch.bfloat16),
             ((64, 2048), torch.float32), ((1000003,), torch.bfloat16)]
    assert_update_bit_for_bit(cuda, specs, seed=1)


@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_adamw_update_bit_for_bit_at_misaligned_tails(cuda, grad_dtype):
    """Numels 1 to 17, around a chunk and a vector, empty tensors, bf16
    and float32 parameters, aligned and one element off."""
    ns = [0, 1, 2, 7, 8, 9, 15, 16, 17, 65535, 65536, 65537, 131079]
    specs = [((n,), dt) for n in ns for dt in (torch.bfloat16, torch.float32)]
    assert_update_bit_for_bit(cuda, specs, seed=2, grad_dtype=grad_dtype,
                              misaligned=set(range(1, len(specs), 2)))


def test_grad_sumsq_close_to_torch_sum_and_repeatable(cuda):
    """Each tensor's sum within rtol 1e-6 of ``torch.sum(torch.square(
    g.float()))``, and the same bits in two runs: deepseek's largest leaf,
    zamba2's shapes cut by 9 (some off 16 bytes), float32 gradients,
    ragged and empty ones."""
    specs = [((64, 2048, 2, 1408), torch.bfloat16), ((0,), torch.bfloat16),
             ((65537,), torch.float32), ((13,), torch.bfloat16)] \
        + [(tuple(max(1, d // 9) for d in s), dt)
           for s, dt in bench_shapes("zamba2")]
    grads = adamw_lists(cuda, specs, seed=3,
                        misaligned=set(range(4, len(specs), 7)))[1]
    before = ops.grad_sumsq.launches
    first, second = ops.grad_sumsq(grads), ops.grad_sumsq(grads)
    assert ops.grad_sumsq.launches - before == 2
    assert first.dtype == torch.float32 and first.shape == (len(grads),)
    assert torch.equal(bits(first), bits(second))
    want = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
    np.testing.assert_allclose(first.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=0)
    assert float(first[1]) == 0.0


def test_adamw_kernels_refuse_bad_input_without_falling_back(cuda):
    lists = adamw_lists(cuda, [((5, 3), torch.bfloat16),
                               ((8,), torch.float32)])
    scalars = adamw_scalars(cuda)
    before = (ops.adamw_update.launches, ops.grad_sumsq.launches)
    bad = [list(x) for x in lists]
    bad[3][0] = torch.zeros(3, 5, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        ops.adamw_update(*bad, **scalars, **ADAMW_CONSTS)
    with pytest.raises(ValueError, match="several devices"):
        ops.adamw_update(*lists, **dict(scalars, lr=torch.tensor(1e-3)),
                         **ADAMW_CONSTS)
    bad = [list(x) for x in lists]
    bad[2][1] = bad[2][1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        ops.adamw_update(*bad, **scalars, **ADAMW_CONSTS)
    with pytest.raises(ValueError, match="several devices"):
        ops.grad_sumsq([lists[1][0], lists[1][1].cpu()])
    assert (ops.adamw_update.launches, ops.grad_sumsq.launches) == before


def test_adamw_kernels_link_to_their_launch_under_the_profiler(cuda):
    """Under ``torch.profiler`` each kernel of the two calls links to its
    call's host operation (``spans.launch``: ``adamw.grad_sumsq``,
    ``adamw.update``), so a span reader counts it in the span that holds
    the call; without it a ctypes launch links to no operation."""
    from torch.profiler import ProfilerActivity, profile
    lists = adamw_lists(cuda, [((1 << 20,), torch.bfloat16),
                               ((8,), torch.float32)])
    scalars = adamw_scalars(cuda)

    def calls():
        ops.grad_sumsq(lists[1])
        ops.adamw_update(*lists, **scalars, **ADAMW_CONSTS)
        torch.cuda.synchronize()
    calls()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        calls()
    events = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e.name() for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU}
    want = {"::update_kernel(": "adamw.update",
            "::sumsq_kernel(": "adamw.grad_sumsq",
            "::sumsq_finish_kernel(": "adamw.grad_sumsq"}
    seen = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for key, launcher in want.items():
            if key in e.name():
                seen[key] = host.get(e.linked_correlation_id())
    assert seen == want
