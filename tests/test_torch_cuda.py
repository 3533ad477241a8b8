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
@pytest.mark.parametrize("b,t,hq,hkv,d,ring,softcap,pos", [
    (4, 544, 8, 4, 256, False, 50.0, [511, 300, 0, 543]),
    (4, 544, 8, 4, 256, True, 50.0, [600, 543, 10, 2000]),
    (1, 4096, 8, 4, 256, True, 50.0, [4700]),
    (2, 40, 4, 2, 16, False, None, [3, 39]),
    (3, 100, 8, 1, 64, True, 30.0, [0, 99, 150]),
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
        got = ops.sim_relax(*args, n_steps=steps)
        assert ops.sim_relax.launches == before + 1
        want = sim_step.sim_relax_torch(*args, n_steps=steps)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.cpu().numpy(), relax_batch_np(batch),
                               rtol=1e-5, atol=0.0)


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
