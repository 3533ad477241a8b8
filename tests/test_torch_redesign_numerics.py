"""The kernels redesigned for Hopper, held on the CPU to what the card
computes: ``sim_relax_pop``'s exact stop at the fixpoint and its launch
rule, ``ssd_scan``'s three-pass bf16 arithmetic, the dense ``sim_relax``'s
compact variant and ``flash_decode``'s split rule and arithmetic.

``sim_relax_pop`` (``csrc/sim_relax_pop.cu``) stops a row at its first
sweep that leaves the ends unchanged bit for bit.
``sim_step.fixpoint_sweeps_torch`` is that stop in plain PyTorch, and
the card's tests hold the kernel's sweep counts to it. Here, on the
device GA's two apps (``chip_smoke.device_ga_apps``: the largest app of
the 64-core paper suite and a 242-task app on 256 cores, 32 random gene
rows) and on the offline 64core and 256core batches (engine schedules,
jitter 0), the stopped loop equals ``sim_relax_pop_torch`` at
``n_steps = S`` bit for bit and stops well before S. On the device GA's
apps it also equals the scan ``population_ends`` and the reference's
``repro.search.device.population_ends``; on the offline batches, the
``n_steps = depth`` sweeps the path runs. A cyclic ``pred`` never stops
early, and ``n_steps`` below the depth runs exactly ``n_steps`` sweeps.
``pop_plan``, the rule that picks the cluster size and the variant, is
pinned at every main-path shape.

``ssd_scan`` (``csrc/ssd_scan.cu``) runs in bf16 as three passes with the
products on the tensor cores: bf16 operands, float32 sums, and every
float32 operand (M, the carried state, w B) split into bf16 hi + lo.
:func:`three_pass_emulation` computes that arithmetic in plain PyTorch,
and the tests hold it within the card's gate
(``tests/test_torch_cuda.py::assert_close_to_plain``: 2 bf16 ulps of
max(|want|, max|want| / 256)) of the port's ``ssd_scan_torch`` and of the
reference's Pallas kernel in interpret mode, at reduced lengths with
mamba2-780m's (H 48, P 64, N 128) and zamba2-7b's (N 64) head shapes,
A and dt drawn as Mamba-2's init so that the carried state shows. M as
one bf16 (no lo part) must fail that gate by more than 4x at every shape.

The dense ``sim_relax`` (``csrc/sim_step.cu``) compacts the (B, S, S)
lags on the card into that gather form (``compact_lags_torch`` is the
pass in plain PyTorch) and relaxes it with the stop at the fixpoint; the
result must equal ``n_steps`` dense sweeps bit for bit. Here, on lowered
batches of small apps on the 64-core and 256-core machines, at the depth
and below it, the compact form stopped at its fixpoint equals
``sim_relax_torch`` and the reference's Pallas ``sim_relax`` in interpret
mode; ``sim_relax_variants_torch`` (the card's choice of variant with the
plain versions) sends a scenario with NaN or +inf inputs, a lag pair with
one side -inf, or a row too wide to the dense variant, and redoes one
that overflows, with the dense plain result.

``flash_decode`` (``csrc/flash_decode.cu``) cuts each (b, kv head)'s
cache into ranges by ``decode_plan``, runs an online softmax over
32-slot tiles in each range and combines the ranges. The plan is pinned
at the serving paths' shapes, and :func:`split_decode_emulation`, that
arithmetic in plain PyTorch, stays within the card's gate of the plain
version and of the reference's Pallas kernel in interpret mode.

Inputs are drawn with NumPy from a seed.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro.search.device as RD
import repro_torch.core as T
import repro_torch.search.device as TD
from repro.kernels import ops as jax_ops
from repro.kernels.sim_step import sim_relax as jax_sim_relax
from repro_torch.core.lowering import dense_lags
from repro_torch.core.sim_engine import _pop_gather_inputs
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import sim_step
from repro_torch.kernels.ssd_scan import chunk_cumsum, ssd_scan_torch

# ---------------------------------------------------------------------------
# sim_relax_pop: the stop at the fixpoint
# ---------------------------------------------------------------------------


@functools.cache
def device_ga_app(pkg, name):
    """``chip_smoke.device_ga_apps()``'s two apps, in either package."""
    if name == "64core":
        graph = max(pkg.paper_suite_64core(n_apps=10, seed=100),
                    key=lambda g: g.n_subtasks)
        return graph, pkg.hp_bl260c()
    return (pkg.generate_app(pkg.SynthParams(n_tasks=(240, 280)), seed=300),
            pkg.cluster_of_multicores(32))


def offline_batch(name):
    """The offline path's plain batch of ``chip_smoke.py`` phase 2."""
    if name == "64core":
        machine = T.hp_bl260c()
        graphs = T.paper_suite_64core(n_apps=10, seed=100)
    else:
        machine = T.cluster_of_multicores(32)
        graphs = [T.generate_app(T.SynthParams(n_tasks=(240, 280)),
                                 seed=300 + i) for i in range(4)]
    mapper = T.get_scheduler("engine")
    return T.batch_scenarios([T.lower_scenario(g, machine, mapper(g, machine))
                              for g in graphs])


@pytest.mark.parametrize("name", ["64core", "256core"])
def test_device_ga_stop_is_exact_and_equals_the_scans(name):
    (gr, mr), (gt, mt) = device_ga_app(R, name), device_ga_app(T, name)
    genes = np.random.default_rng(7).integers(0, mt.n_cores,
                                              (32, len(gt.tasks)),
                                              dtype=np.int32)
    inp = TD.device_inputs(gt, mt, device="cpu")
    args = TD.population_gather_inputs(inp, torch.from_numpy(genes))
    s = inp.n_subtasks
    ends, sweeps = sim_step.fixpoint_sweeps_torch(*args, n_steps=s)
    assert sweeps.dtype == torch.int32 and sweeps.shape == (32,)
    assert int(sweeps.max()) < s // 4          # 5-8x fewer sweeps than S
    assert int(sweeps.min()) >= 2
    assert torch.equal(ends, sim_step.sim_relax_pop_torch(*args, n_steps=s))
    assert torch.equal(ends, TD.population_ends(inp, torch.from_numpy(genes)))
    want = RD.population_ends(RD.device_inputs(gr, mr), jnp.asarray(genes))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["64core", "256core"])
def test_offline_stop_is_exact_and_equals_the_depth_sweeps(name):
    batch = offline_batch(name)
    pred, lat, volbw = _pop_gather_inputs(batch)
    args = [torch.from_numpy(x) for x in
            (pred, lat, volbw, batch.duration.astype(np.float32),
             batch.release.astype(np.float32))]
    s = batch.max_subtasks
    ends, sweeps = sim_step.fixpoint_sweeps_torch(*args, n_steps=s)
    assert int(sweeps.max()) <= batch.depth + 1 < s
    assert torch.equal(ends, sim_step.sim_relax_pop_torch(*args, n_steps=s))
    assert torch.equal(ends, sim_step.sim_relax_pop_torch(
        *args, n_steps=batch.depth))


def cyclic_inputs(seed, b, s, p1):
    """Random sources, so every row has cycles; positive lags make each
    sweep raise the ends on a cycle, so no row ever settles."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, s, (b, s, p1)).astype(np.int32)
    lat = rng.uniform(0.0, 1e-3, (b, s, p1)).astype(np.float32)
    volbw = rng.uniform(0.5, 5.0, (b, s, p1)).astype(np.float32)
    dur = rng.uniform(0.1, 10.0, (b, s)).astype(np.float32)
    rel = np.zeros((b, s), np.float32)
    return [torch.from_numpy(x) for x in (pred, lat, volbw, dur, rel)]


def test_cyclic_pred_never_stops_early():
    args = cyclic_inputs(3, 5, 60, 4)
    ends, sweeps = sim_step.fixpoint_sweeps_torch(*args, n_steps=200)
    assert torch.equal(sweeps, torch.full((5,), 200, dtype=torch.int32))
    assert torch.equal(ends, sim_step.sim_relax_pop_torch(*args,
                                                          n_steps=200))


@pytest.mark.parametrize("n_steps", [0, 1, 7])
def test_n_steps_below_the_depth_is_left_untouched(n_steps):
    graph, machine = device_ga_app(T, "64core")
    inp = TD.device_inputs(graph, machine, device="cpu")
    genes = torch.from_numpy(np.random.default_rng(1).integers(
        0, machine.n_cores, (8, len(graph.tasks)), dtype=np.int32))
    args = TD.population_gather_inputs(inp, genes)
    ends, sweeps = sim_step.fixpoint_sweeps_torch(*args, n_steps=n_steps)
    assert torch.equal(sweeps, torch.full((8,), n_steps, dtype=torch.int32))
    assert torch.equal(ends, sim_step.sim_relax_pop_torch(
        *args, n_steps=n_steps))


# (B, S, P+1) of every main path that launches sim_relax_pop, and the
# plan the rule gives: (k, variant, shared bytes per CTA, threads)
MAIN_PATH_PLANS = {
    (32, 815, 23): (4, "staged", 55_096, 224),       # device GA, 64core
    (32, 1090, 27): (4, "staged", 84_640, 288),      # device GA, 256core
    (10, 815, 28): (8, "staged", 35_920, 128),       # offline / verify
    (160, 815, 28): (1, "l2", 6_544, 832),           # offline / verify
    (4, 1235, 31): (16, "staged", 34_708, 96),       # offline
    (64, 1235, 31): (2, "staged", 206_428, 640),     # offline
    (16, 5628, 8): (8, "staged", 107_000, 704),      # online recovery GA
    (32, 5628, 8): (4, "staged", 168_864, 1024),     # online recovery GA
}


@pytest.mark.parametrize("shape", sorted(MAIN_PATH_PLANS))
def test_launch_rule_at_the_main_path_shapes(shape):
    plan = sim_step.pop_plan(*shape)
    assert tuple(plan) == MAIN_PATH_PLANS[shape]
    assert plan.shared_bytes == sim_step.pop_shared_bytes(
        shape[1], shape[2], -(-shape[1] // plan.k), plan.variant == "staged")


@pytest.mark.parametrize("b", [1, 2, 3, 8, 9, 16, 17, 33, 66, 67, 132, 160])
def test_launch_rule_fills_the_card_once(b):
    """k is a power of two up to 16, the B * k CTAs fit 132 SMs (k = 1
    whenever B alone is more), every CTA keeps 32 subtasks or more, and
    the staged variant fits a block and one wave."""
    for s, p1 in ((33, 3), (815, 28), (1235, 31), (5000, 40)):
        plan = sim_step.pop_plan(b, s, p1)
        assert plan.k in (1, 2, 4, 8, 16)
        assert plan.k == 1 or b * plan.k <= sim_step.SMS
        assert plan.k == 1 or -(-s // plan.k) >= sim_step.MIN_SLICE
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        if plan.k < 16 and b * plan.k * 2 <= sim_step.SMS:
            assert -(-s // (2 * plan.k)) < sim_step.MIN_SLICE
        if plan.variant == "staged":
            assert plan.shared_bytes <= sim_step.MAX_SHARED_BYTES
            assert b * plan.k * (plan.shared_bytes
                                 + sim_step.CTA_RESERVED_BYTES) \
                <= sim_step.SMS * sim_step.SM_SHARED_BYTES


# ---------------------------------------------------------------------------
# ssd_scan: the three-pass bf16 arithmetic
# ---------------------------------------------------------------------------


def gate_ratio(got, want):
    """Largest error over the bf16 gate's bound (<= 1 passes): 2 bf16
    ulps of max(|want|, max|want| / 256)."""
    g, w = got.double(), want.double()
    amax = float(w.abs().max())
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    bound = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / bound).max())


def bf16(t):
    return t.bfloat16().float()


def split(t):
    """A float32 operand as bf16 hi + lo (hi + lo within 2^-17 of t)."""
    hi = bf16(t)
    return hi, bf16(t - hi)


def three_pass_emulation(x, dt, A, B, C, chunk, *, split_m=True):
    """The bf16 kernel's arithmetic on (B, S, H, P) / (B, S, G, N) bf16
    inputs: pass 1 the chunk's float64-summed cumsum and its local state
    x^T (w B) with w B split into hi + lo; pass 2 the carry
    state_in[c] = state_in[c-1] exp(cs_end) + local[c-1]; pass 3
    y = (C B^T * L * dt) x + exp(cs) (C state_in^T), C B^T of the bf16
    operands in float32, M and the state split into hi + lo (M as one
    bf16 where not ``split_m``, the negative control). Products of bf16
    values are exact in float32 and every sum is float32, as on the
    tensor cores. Returns (y, final state) in bf16."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    pad_s = torch.nn.functional.pad

    def chunks(t, width):                    # (b, S, h, w) -> (b, h, nc, L, w)
        t = pad_s(t, (0, 0, 0, 0, 0, pad))
        return t.view(b, nc, chunk, h, width).permute(0, 3, 1, 2, 4)

    xc = chunks(x.float(), p)
    Bc = chunks(B.float().repeat_interleave(rep, dim=2), n)
    Cc = chunks(C.float().repeat_interleave(rep, dim=2), n)
    dtc = pad_s(dt.float(), (0, 0, 0, pad)).view(b, nc, chunk, h) \
        .permute(0, 3, 1, 2)
    cs = chunk_cumsum(dtc * A.float()[None, :, None, None])
    # pass 1
    wh, wl = split((torch.exp(cs[..., -1:] - cs) * dtc)[..., None] * Bc)
    xt = xc.transpose(-1, -2)
    local = xt @ wh + xt @ wl
    # pass 2
    state = torch.zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cs[:, :, c, -1])[..., None, None] \
            + local[:, :, c]
    sh, sl = split(torch.stack(entering, dim=2))
    # pass 3
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]),
                    0.0)
    M = (Cc @ Bc.transpose(-1, -2)) * L * dtc[..., None, :]
    if split_m:
        mh, ml = split(M)
        y = mh @ xc + ml @ xc
    else:
        y = bf16(M) @ xc
    off = Cc @ sh.transpose(-1, -2) + Cc @ sl.transpose(-1, -2)
    y = y + torch.exp(cs)[..., None] * off
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * chunk, h, p)[:, :s]
    return y.bfloat16(), state.bfloat16()


def scan_inputs(seed, b, s, h, p, g, n):
    """bf16 x, B, C and float32 dt, A: A in -[1, 16], dt log-uniform in
    [1e-3, 1e-1] (Mamba-2's init, so the carried state is far from
    zero)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h)))
    A = -rng.uniform(1.0, 16.0, h)
    B = rng.standard_normal((b, s, g, n)) * 0.5
    C = rng.standard_normal((b, s, g, n)) * 0.5
    return [x.astype(np.float32).astype(ml_dtypes.bfloat16),
            dt.astype(np.float32), A.astype(np.float32),
            B.astype(np.float32).astype(ml_dtypes.bfloat16),
            C.astype(np.float32).astype(ml_dtypes.bfloat16)]


def torch_args(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.float32) for a in arrays]


SCAN_SHAPES = [
    (1, 128, 48, 64, 1, 128, 64),      # mamba2-780m's heads, two chunks
    (2, 300, 48, 64, 1, 128, 128),     # ragged: 2 chunks + 44
    (1, 256, 8, 64, 1, 64, 64),        # zamba2-7b's N = 64, four chunks
    (2, 200, 8, 64, 2, 64, 96),        # two groups, ragged, chunk 96
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES)
def test_three_pass_bf16_within_the_gate_of_the_plain_version(
        b, s, h, p, g, n, chunk):
    args = torch_args(scan_inputs(s + h, b, s, h, p, g, n))
    y, state = three_pass_emulation(*args, chunk)
    want_y, want_state = ssd_scan_torch(*args, chunk)
    assert float(want_state.float().abs().max()) > 0.1      # a live carry
    assert gate_ratio(y, want_y) <= 1
    assert gate_ratio(state, want_state) <= 1


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [SCAN_SHAPES[0],
                                               SCAN_SHAPES[2]])
def test_three_pass_bf16_within_the_gate_of_the_reference_kernel(
        b, s, h, p, g, n, chunk):
    """The reference's Pallas ``ssd_scan`` in interpret mode (it takes
    only S a multiple of chunk)."""
    arrays = scan_inputs(s + h, b, s, h, p, g, n)
    want_y, want_state = jax_ops.ssd_scan(*map(jnp.asarray, arrays), chunk)
    y, state = three_pass_emulation(*torch_args(arrays), chunk)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))   # noqa: E731
    assert gate_ratio(y, as_t(want_y)) <= 1
    assert gate_ratio(state, as_t(want_state)) <= 1


# the negative control's error over the gate's bound at these inputs
# (seed 11): 18, 22, 13.6 and 46.5, against 0.5 for the split M
CONTROL_MARGIN = 4.0


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SCAN_SHAPES)
def test_m_as_one_bf16_fails_the_gate(b, s, h, p, g, n, chunk):
    """Why M is split: rounded once to bf16 before M x (8 bits of each
    weight), y leaves the gate where its terms cancel, by more than 4x
    the gate, while the same inputs with M split stay inside it."""
    args = torch_args(scan_inputs(11, b, s, h, p, g, n))
    want_y, _ = ssd_scan_torch(*args, chunk)
    y, _ = three_pass_emulation(*args, chunk, split_m=False)
    assert gate_ratio(y, want_y) > CONTROL_MARGIN
    y, _ = three_pass_emulation(*args, chunk)
    assert gate_ratio(y, want_y) <= 1


# ---------------------------------------------------------------------------
# the dense sim_relax: compact the lags, stop at the fixpoint
# ---------------------------------------------------------------------------


@functools.cache
def small_dense_batch(kind):
    """A lowered batch of three small apps (20-40 tasks) on the 64-core
    paper machine or the 256-core cluster, engine schedules, and its
    dense inputs in float32."""
    m = T.hp_bl260c() if kind == "64core" else T.cluster_of_multicores(32)
    graphs = [T.generate_app(T.SynthParams(n_tasks=(20, 40)), seed=50 + i)
              for i in range(3)]
    batch = T.batch_scenarios([T.lower_scenario(g, m, T.engine_schedule(g, m))
                               for g in graphs])
    lat, volbw = dense_lags(batch)
    arrays = [np.ascontiguousarray(x, np.float32)
              for x in (lat, volbw, batch.duration, batch.release)]
    return batch, arrays


def dense_tensors(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("kind", ["64core", "256core"])
@pytest.mark.parametrize("below_depth", [False, True])
def test_compact_form_stopped_at_its_fixpoint_equals_the_dense_sweeps(
        kind, below_depth):
    batch, arrays = small_dense_batch(kind)
    args = dense_tensors(arrays)
    steps = batch.depth // 3 if below_depth else batch.depth
    comp = sim_step.compact_lags_torch(*args)
    assert comp.rows.tolist() == [0, 1, 2]
    p1 = comp.pred.shape[2]
    assert 2 <= p1 <= batch.max_preds + 1 < batch.max_subtasks // 4
    ends, sweeps = sim_step.fixpoint_sweeps_torch(*comp[:3], *args[2:],
                                                  n_steps=steps)
    want = sim_step.sim_relax_torch(*args, n_steps=steps)
    assert torch.equal(ends, want)
    assert int(sweeps.max()) <= steps
    if below_depth:
        assert torch.equal(sweeps, torch.full((3,), steps, dtype=torch.int32))
    got, info = sim_step.sim_relax_variants_torch(*args, n_steps=steps)
    assert torch.equal(got, want)
    assert bool(info.compact.all()) and not bool(info.redone.any())
    assert torch.equal(info.sweeps, sweeps) and info.p1 == p1


def test_compact_variant_equals_the_reference_pallas_sim_relax():
    batch, arrays = small_dense_batch("64core")
    got, info = sim_step.sim_relax_variants_torch(*dense_tensors(arrays),
                                                  n_steps=batch.depth)
    assert bool(info.compact.all())
    want = np.asarray(jax_sim_relax(*arrays, n_steps=batch.depth,
                                    interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def same_or_both_nan(got, want):
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def spoil(arrays, how):
    """Scenario 1 of the batch made unfit for the compact variant."""
    lat, volbw, dur, rel = (a.copy() for a in arrays)
    edge = np.argwhere(lat[1] > -np.inf)[3]
    gap = np.argwhere(lat[1] == -np.inf)[5]
    if how == "nan lat":
        lat[1][tuple(edge)] = np.nan
    elif how == "nan in a non-edge":
        volbw[1][tuple(gap)] = np.nan
    elif how == "+inf volbw":
        volbw[1][tuple(edge)] = np.inf
    elif how == "+inf in a non-edge":
        lat[1][tuple(gap)] = np.inf
    elif how == "nan dur":
        dur[1, 4] = np.nan
    elif how == "+inf rel":
        rel[1, 7] = np.inf
    elif how == "one lag -inf":
        lat[1][tuple(edge)] = -np.inf
    return [lat, volbw, dur, rel]


@pytest.mark.parametrize("how", ["nan lat", "nan in a non-edge",
                                 "+inf volbw", "+inf in a non-edge",
                                 "nan dur", "+inf rel", "one lag -inf"])
def test_compaction_refuses_nan_and_inf_inputs(how):
    batch, arrays = small_dense_batch("64core")
    args = dense_tensors(spoil(arrays, how))
    assert sim_step.compact_lags_torch(*args).rows.tolist() == [0, 2]
    want = sim_step.sim_relax_torch(*args, n_steps=batch.depth)
    got, info = sim_step.sim_relax_variants_torch(*args, n_steps=batch.depth)
    assert info.compact.tolist() == [True, False, True]
    assert same_or_both_nan(got, want)


def test_a_row_wider_than_the_compact_width_goes_dense():
    b, s = 2, 100
    rng = np.random.default_rng(5)
    lat = np.where(rng.random((b, s, s)) < 0.1,
                   rng.uniform(0.0, 1e-3, (b, s, s)), -np.inf)
    lat[1, 7, :sim_step.COMPACT_MAX + 1] = 1e-4   # 65 entries in one row
    volbw = np.where(lat > -np.inf, rng.uniform(0.0, 2.0, (b, s, s)), -np.inf)
    dur = rng.uniform(0.1, 5.0, (b, s))
    rel = rng.uniform(0.0, 20.0, (b, s))
    args = [torch.from_numpy(x.astype(np.float32))
            for x in (lat, volbw, dur, rel)]
    assert sim_step.compact_width(s) == sim_step.COMPACT_MAX
    assert sim_step.compact_lags_torch(*args).rows.tolist() == [0]
    got, info = sim_step.sim_relax_variants_torch(*args, n_steps=s)
    assert info.compact.tolist() == [True, False]
    assert torch.equal(got, sim_step.sim_relax_torch(*args, n_steps=s))


def test_overflow_is_detected_and_gives_the_dense_plain_result():
    """A chain whose ends pass the float32 range: the compact sweeps
    reach +inf (where the dense sweeps turn it into NaN through the -inf
    non-edges), the flag sends the scenario back to the dense variant,
    and the result is the plain one, NaN at the same places."""
    batch, arrays = small_dense_batch("64core")
    lat, volbw, dur, rel = (a.copy() for a in arrays)
    dur[2] = 1e38
    args = dense_tensors((lat, volbw, dur, rel))
    comp = sim_step.compact_lags_torch(*args)
    assert comp.rows.tolist() == [0, 1, 2]      # finite inputs: compacted
    _, _, over = sim_step.fixpoint_sweeps_torch(
        *comp[:3], *args[2:], n_steps=batch.depth, with_overflow=True)
    assert over.tolist() == [False, False, True]
    want = sim_step.sim_relax_torch(*args, n_steps=batch.depth)
    assert bool(torch.isnan(want[2]).any())
    got, info = sim_step.sim_relax_variants_torch(*args, n_steps=batch.depth)
    assert info.compact.tolist() == [True, True, False]
    assert info.redone.tolist() == [False, False, True]
    assert same_or_both_nan(got, want)


# ---------------------------------------------------------------------------
# flash_decode: the split rule and its arithmetic
# ---------------------------------------------------------------------------

# (B, T, Hkv, D, Dv, G) of the serving paths: gemma2-2b run A (B=4, 544
# slots), run B's global layers (4,624) and its local layers' 4,096-slot
# ring, run C's batcher (4 slots of 1,024), zamba2-7b run D
DECODE_PATH_SHAPES = [
    (4, 544, 4, 256, 256, 2),
    (1, 4624, 4, 256, 256, 2),
    (1, 4096, 4, 256, 256, 2),
    (4, 1024, 4, 256, 256, 2),
    (2, 716, 32, 224, 224, 1),
]


@pytest.mark.parametrize("b,t,hkv,d,dv,g", DECODE_PATH_SHAPES)
def test_decode_plan_fills_the_card_at_the_path_shapes(b, t, hkv, d, dv, g):
    """bf16: two blocks fit an SM, so the split launch holds between one
    and two blocks per SM of the 132, in one wave; every range holds at
    least one tile and none is empty."""
    plan = fd.decode_plan(b, t, hkv, d, dv=dv, g=g, itemsize=2)
    assert plan.gr == g and plan.gchunks == 1
    assert 2 * (plan.shared_bytes + fd.CTA_RESERVED_BYTES) \
        <= fd.SM_SHARED_BYTES
    assert fd.SMS <= plan.blocks <= 2 * fd.SMS
    assert plan.blocks == b * hkv * plan.splits
    assert plan.chunk >= fd.TILE
    assert (plan.splits - 1) * plan.chunk < t <= plan.splits * plan.chunk


def test_decode_plan_at_a_tiny_cache_and_in_float32():
    assert fd.decode_plan(1, 16, 4, 256, g=2).splits == 1
    assert fd.decode_plan(4, 40, 4, 256, g=2).splits == 1
    plan = fd.decode_plan(1, 4624, 4, 256, g=2, itemsize=4)
    assert plan.shared_bytes > fd.SM_SHARED_BYTES // 2   # one block per SM
    assert plan.blocks == fd.SMS
    plan = fd.decode_plan(1, 200, 1, 64, g=8)            # MQA: 2 chunks of 4
    assert (plan.gr, plan.gchunks) == (4, 2)


def online_merge(ms, ls, accs):
    """States (running max, sum, accumulator) stacked on dim 0, merged in
    order: rescaled to their common max and added."""
    w = torch.exp(ms - ms.amax(0))
    return ms.amax(0), (ls * w).sum(0), (accs * w[..., None]).sum(0)


def split_decode_emulation(q, kc, vc, pos, *, scale=None, softcap=None,
                           ring=False):
    """The card's arithmetic in plain PyTorch, float32: per (b, kv head)
    the ranges of ``decode_plan``; in each range, 32-slot tiles whose
    slots 4w .. 4w+3 belong to warp w, each warp an online softmax over
    its slots (running max from -2e38, rescale, running sum and
    accumulator); the warps' states merged, then the ranges that hold a
    valid slot, and the sum divided by the rescaled sum (at least
    1e-30)."""
    b, hq, d = q.shape
    t, hkv, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    g = hq // hkv
    plan = fd.decode_plan(b, t, hkv, d, dv=dv, g=g,
                          itemsize=q.element_size())
    per_warp = fd.TILE // fd.WARPS
    scale = d ** -0.5 if scale is None else scale
    qs = (q.float() * scale).view(b, hkv, g, d)
    kf, vf = kc.float(), vc.float()
    out = torch.empty((b, hkv, g, dv))
    for bi in range(b):
        p = int(pos[bi])
        lim = (min(p, t - 1) if ring else p) + 1
        ranges = []
        for t0 in range(0, lim, plan.chunk):
            n = min(plan.chunk, lim - t0)
            nt = -(-n // fd.TILE)
            pad = (0, 0, 0, 0, 0, nt * fd.TILE - n)
            k = torch.nn.functional.pad(kf[bi, t0:t0 + n], pad)
            v = torch.nn.functional.pad(vf[bi, t0:t0 + n], pad) \
                .view(nt, fd.WARPS, per_warp, hkv, dv)
            s = torch.einsum("kgd,tkd->kgt", qs[bi], k)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            valid = (torch.arange(nt * fd.TILE) < n) \
                .view(nt, fd.WARPS, 1, 1, per_warp)
            s = s.view(hkv, g, nt, fd.WARPS, per_warp).permute(2, 3, 0, 1, 4)
            s = s.masked_fill(~valid, fd.NEG_INF)
            m = torch.full((fd.WARPS, hkv, g), fd.NEG_INF)
            l_ = torch.zeros((fd.WARPS, hkv, g))
            acc = torch.zeros((fd.WARPS, hkv, g, dv))
            for it in range(nt):            # each warp's online softmax
                m_new = torch.maximum(m, s[it].amax(-1))
                alpha = torch.exp(m - m_new)
                pr = torch.where(valid[it], torch.exp(s[it] - m_new[..., None]),
                                 0.0)
                l_ = l_ * alpha + pr.sum(-1)
                acc = acc * alpha[..., None] \
                    + torch.einsum("wkgt,wtkd->wkgd", pr, v[it])
                m = m_new
            ranges.append(online_merge(m, l_, acc))
        _, l_, acc = online_merge(*(torch.stack(x) for x in zip(*ranges)))
        out[bi] = acc / l_.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, dv).to(q.dtype)


def decode_inputs(seed, b, t, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(dtype)
                 for shape in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    return q, kc, vc


def within_gate(got, want):
    """The card's tolerance (``tests/test_torch_cuda.py``
    ``assert_close_to_plain``): rtol 1e-5 with a floor of 1e-5 x max|want|
    in float32, 2 bf16 ulps of max(|want|, max|want| / 256) in bf16."""
    if want.dtype == torch.bfloat16:
        return gate_ratio(got, want) <= 1
    g, w = got.double(), want.double()
    return bool(((g - w).abs() <= 1e-5 * w.abs()
                 + 1e-5 * float(w.abs().max())).all())


# (B, T, Hq, Hkv, D, ring, softcap, pos): the path shapes at the
# positions the runs reach, then ragged and small ones
DECODE_CASES = [
    (4, 544, 8, 4, 256, False, 50.0, [511, 300, 0, 543]),
    (1, 4624, 8, 4, 256, False, 50.0, [4623]),
    (1, 4096, 8, 4, 256, True, 50.0, [4620]),
    (2, 716, 32, 32, 224, False, None, [700, 715]),
    (3, 1001, 8, 4, 256, True, 50.0, [5, 1000, 3000]),
    (2, 100, 4, 2, 20, False, None, [37, 99]),
    (1, 200, 8, 1, 64, False, 30.0, [0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hq,hkv,d,ring,softcap,pos", DECODE_CASES)
def test_split_decode_within_the_gate_of_the_plain_version(
        dtype, b, t, hq, hkv, d, ring, softcap, pos):
    q, kc, vc = decode_inputs(t + hq, b, t, hq, hkv, d, dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    got = split_decode_emulation(q, kc, vc, p, softcap=softcap, ring=ring)
    want = fd.flash_decode_torch(q, kc, vc, p, softcap=softcap, ring=ring)
    assert within_gate(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,hq,hkv,d,ring,softcap,pos", [
    (2, 100, 4, 2, 32, False, None, [37, 99]),     # linear, ragged T
    (1, 200, 8, 1, 64, False, 30.0, [0]),          # softcap, MQA
    (2, 128, 4, 4, 32, True, None, [60, 300]),     # ring: not yet, wrapped
    (3, 64, 4, 2, 16, True, 50.0, [15, 16, 40]),   # ring, softcap
])
def test_split_decode_within_the_gate_of_the_reference_kernel(
        dtype, b, t, hq, hkv, d, ring, softcap, pos):
    """The reference's Pallas ``flash_decode`` in interpret mode (kv_block
    64; ring caches of a whole number of blocks, where its padded slots
    stay masked)."""
    q, kc, vc = decode_inputs(t + hq, b, t, hq, hkv, d, dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    got = split_decode_emulation(q, kc, vc, p, softcap=softcap, ring=ring)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_ops.flash_decode(
        *(jnp.asarray(x.float().numpy(), jdt) for x in (q, kc, vc)),
        jnp.asarray(pos, jnp.int32), ring=ring, softcap=softcap, kv_block=64)
    assert within_gate(got, torch.from_numpy(
        np.array(want, np.float32)).to(dtype))
