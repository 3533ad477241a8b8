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
