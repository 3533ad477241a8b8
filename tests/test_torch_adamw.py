"""The port's multi-tensor AdamW on the CPU: the plain versions behind
``ops.grad_sumsq`` and ``ops.adamw_update`` (what ``apply_updates`` runs
here) against the JAX package's ``apply_updates`` over three steps, the
guards of both wrappers, and the host side of the CUDA kernels: the
chunk table and the table the kernels read. The kernels themselves run
only on the card (``test_torch_cuda.py``)."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import build, ops
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

#: 0 and 1 elements, numels off a multiple of 8 (the kernels' vector)
SHAPES = {"empty": (0,), "one": (1,), "b": (13,), "a": (7, 5),
          "c": (3, 4, 3), "d": (1, 1, 9), "e": (16,)}


def to_jax(x: np.ndarray, dtype) -> jnp.ndarray:
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_match_the_reference_over_three_steps(dtype,
                                                             monkeypatch):
    """Parameters (f32 or bf16, gradients of their type) and float32
    moments after three steps with the clip active, through
    ``apply_updates``, whose one ``grad_sumsq`` and one ``adamw_update`` a
    step take every tensor: float32 within rtol 1e-6 of the reference's;
    bf16 parameters within one bf16 step (2**-7 of the value), the
    moments as float32."""
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    if dtype == torch.bfloat16:             # values a bf16 tensor holds
        params, *grads = [{k: as_f32(torch.from_numpy(v).to(dtype))
                           for k, v in tree.items()}
                          for tree in (params, *grads)]
    jcfg = jax_adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = {k: to_jax(v, dtype) for k, v in params.items()}
    jstate = jax_adamw.init_opt_state(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()).to(dtype) for k, v in params.items()}
    state = init_opt_state(tp, cfg)
    calls = {"grad_sumsq": [], "adamw_update": []}
    for name in calls:
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _real=real, _name=name,
                            **kw: calls[_name].append(len(a[0]))
                            or _real(*a, **kw))
    for g in grads:
        jp, jstate, jstats = jax_adamw.apply_updates(
            jp, {k: to_jax(v, dtype) for k, v in g.items()}, jstate, jcfg)
        tp, state, stats = apply_updates(
            tp, {k: torch.from_numpy(v).to(dtype) for k, v in g.items()},
            state, cfg)
        assert float(stats["grad_norm"]) > 10 * cfg.clip_norm  # clipped
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
    assert calls == {"grad_sumsq": [len(SHAPES)] * 3,
                     "adamw_update": [len(SHAPES)] * 3}
    for k in SHAPES:
        got, want = as_f32(tp[k]), as_f32(jp[k])
        assert tp[k].dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        for part in ("m", "v"):
            np.testing.assert_allclose(state[part][k].numpy(),
                                       np.asarray(jstate[part][k]),
                                       rtol=1e-6, atol=1e-7)


def test_grad_sumsq_plain_is_the_reference_sum_per_tensor():
    rng = np.random.default_rng(6)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in SHAPES.values()]
    grads[2] = grads[2].to(torch.bfloat16)
    got = ops.grad_sumsq(grads)
    assert got.dtype == torch.float32 and got.shape == (len(grads),)
    for s, g in zip(got, grads):
        assert torch.equal(s, torch.sum(torch.square(g.to(torch.float32))))


def update_args():
    shapes = [(5, 3), (8,), (1,)]
    lists = dict(params=[torch.zeros(s, dtype=torch.bfloat16)
                         for s in shapes],
                 grads=[torch.ones(s) for s in shapes],
                 ms=[torch.zeros(s) for s in shapes],
                 vs=[torch.zeros(s) for s in shapes])
    scalars = dict(clip=torch.tensor(0.5), lr=torch.tensor(1e-3),
                   b1c=torch.tensor(0.1), b2c=torch.tensor(0.05))
    return lists, scalars


CONSTS = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def bad_update(what):
    """``adamw_update``'s arguments with one fault planted."""
    lists, scalars = update_args()
    if what == "param dtype":
        lists["params"][1] = lists["params"][1].to(torch.float16)
    elif what == "grad dtype":
        lists["grads"][0] = lists["grads"][0].double()
    elif what == "moment dtype":
        lists["ms"][2] = lists["ms"][2].to(torch.bfloat16)
    elif what == "second moment dtype":
        lists["vs"][0] = lists["vs"][0].to(torch.bfloat16)
    elif what == "numel":
        lists["grads"][1] = torch.ones(9)
    elif what == "shape":
        lists["vs"][0] = torch.zeros(3, 5)
    elif what == "list length":
        lists["ms"] = lists["ms"][:2]
    elif what == "no tensors":
        lists = {k: [] for k in lists}
    elif what == "non-contiguous":
        lists["params"][0] = torch.zeros(3, 5, dtype=torch.bfloat16).t()
    elif what == "devices":
        lists["vs"][1] = torch.zeros(8, device="meta")
    elif what == "scalar shape":
        scalars["lr"] = torch.tensor([1e-3])
    elif what == "scalar dtype":
        scalars["clip"] = torch.tensor(0.5, dtype=torch.float64)
    elif what == "scalar device":
        scalars["b2c"] = torch.tensor(0.05, device="meta")
    return lists, scalars


@pytest.mark.parametrize("what,error", [
    ("param dtype", TypeError), ("grad dtype", TypeError),
    ("moment dtype", TypeError), ("second moment dtype", TypeError),
    ("numel", ValueError), ("shape", ValueError), ("list length", ValueError),
    ("no tensors", ValueError), ("non-contiguous", ValueError),
    ("devices", ValueError), ("scalar shape", ValueError),
    ("scalar dtype", TypeError), ("scalar device", ValueError)])
def test_adamw_update_guards_raise(what, error):
    lists, scalars = bad_update(what)
    before = [x.clone() for x in lists["params"] if x.device.type == "cpu"]
    with pytest.raises(error):
        ops.adamw_update(**lists, **scalars, **CONSTS)
    after = [x for x in lists["params"] if x.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("grads,error", [
    ([torch.ones(4), torch.ones(3, dtype=torch.float64)], TypeError),
    ([torch.ones(4, dtype=torch.float16)], TypeError),
    ([torch.ones(3, 4).t()], ValueError),
    ([torch.ones(4), torch.ones(4, device="meta")], ValueError),
    ([], ValueError)])
def test_grad_sumsq_guards_raise(grads, error):
    with pytest.raises(error):
        ops.grad_sumsq(grads)


def test_adamw_update_runs_the_plain_version_on_the_cpu():
    """The CPU path updates every tensor in place, launches nothing and
    counts nothing."""
    lists, scalars = update_args()
    before = (ops.adamw_update.launches, ops.adamw_update.tensors)
    ops.adamw_update(**lists, **scalars, **CONSTS)
    assert (ops.adamw_update.launches, ops.adamw_update.tensors) == before
    want = update_args()[0]
    aw.adamw_update_torch(*want.values(), **scalars, **CONSTS)
    for key in lists:
        for a, b in zip(lists[key], want[key]):
            assert torch.equal(a, b)
    assert all(bool((p != 0).all()) for p in lists["params"])


def covered(shapes):
    """How often each element of each tensor falls in a chunk."""
    pairs, first = aw.chunk_table(shapes)
    counts = [np.zeros(math.prod(s), dtype=np.int64) for s in shapes]
    for t, off in pairs:
        counts[t][off:off + aw.CHUNK] += 1
    return pairs, first, counts


def test_chunk_table_covers_every_element_once():
    """Empty tensors, tensors under a chunk, and numels around one, two
    and three chunks."""
    c = aw.CHUNK
    shapes = [(0,), (1,), (7,), (c - 1,), (c,), (c + 1,), (3, 5), (0, 4),
              (2, c), (2 * c + 7,), (3, c // 2 + 1), (2, 2, 2)]
    pairs, first, counts = covered(shapes)
    assert all((n == 1).all() for n in counts)
    assert first[0] == 0 and first[-1] == len(pairs)
    for t, s in enumerate(shapes):
        rows = pairs[first[t]:first[t + 1]]
        assert (rows[:, 0] == t).all()
        assert rows[:, 1].tolist() == list(range(0, math.prod(s), c))


def test_chunk_table_offsets_are_64_bit_past_2_31():
    """From shapes alone (no tensor is made): a tensor of 2**31 + 5
    elements, deepseek's largest leaf and others around them, 2.5 B
    elements in all; every element in exactly one chunk, offsets past
    2**31 exact."""
    shapes = [(2 ** 31 + 5,), (0,), (1,), (64, 2048, 2, 1408), (65537,),
              torch.Size([3, 7])]
    total = sum(math.prod(s) for s in shapes)
    assert total > 2 ** 31 + 3 * 10 ** 8
    pairs, first = aw.chunk_table(shapes)
    assert pairs.dtype == np.int64 and first.dtype == np.int64
    chunk = aw.CHUNK
    assert chunk % 8 == 0
    for t, s in enumerate(shapes):
        n = math.prod(s)
        rows = pairs[first[t]:first[t + 1]]
        assert (rows[:, 0] == t).all()
        # consecutive, from 0, the last one holding the tail
        assert (rows[:, 1] == np.arange(len(rows), dtype=np.int64)
                * chunk).all()
        lengths = np.minimum(chunk, n - rows[:, 1])
        assert int(lengths.sum()) == n and (lengths > 0).all()
    assert int(pairs[:, 1].max()) >= 2 ** 31
    assert int(pairs[first[1] - 1, 1]) == (2 ** 31 + 5 - 1) // chunk * chunk


def test_table_words_layout_and_flags():
    """Each tensor's record (addresses, numel, flags, first chunk, chunk
    count), then the chunk pairs; the vector flags need 16-byte
    addresses, g's alone for the sums of squares, all four's for the
    update."""
    shapes = [(3, 5), (0,), (65537,)]
    addresses = np.array([[16, 32, 48, 64], [0, 18, 0, 0],
                          [160, 176, 200, 208]], dtype=np.int64)
    flags = aw._flags(addresses, [True, False, False], [False, True, True])
    assert flags.tolist() == [aw.P_BF16 + aw.G_VEC + aw.ALL_VEC, aw.G_BF16,
                              aw.G_BF16 + aw.G_VEC]
    words, n_chunks = aw.table_words(addresses, shapes, flags)
    assert words.dtype == np.int64 and n_chunks == 1 + 0 + 2
    rec = words[:3 * aw.TENSOR_WORDS].reshape(3, aw.TENSOR_WORDS)
    assert (rec[:, :4] == addresses).all()
    assert rec[:, 4].tolist() == [15, 0, 65537]
    assert (rec[:, 5] == flags).all()
    assert rec[:, 6].tolist() == [0, 1, 1] and rec[:, 7].tolist() == [1, 0, 2]
    assert words[3 * aw.TENSOR_WORDS:].reshape(-1, 2).tolist() == \
        [[0, 0], [2, 0], [2, aw.CHUNK]]


def test_chunk_size_is_the_kernels():
    """The host's chunk table and the kernels cut tensors alike: CHUNK is
    csrc/adamw.cu's kChunk."""
    src = (build.CSRC / "adamw.cu").read_text()
    m = re.search(r"constexpr long long kChunk = ([^;]+);", src)
    assert m and eval(m.group(1), {}) == aw.CHUNK


def test_adamw_source_keeps_to_exact_arithmetic():
    """No atomics (the sums repeat bit for bit), no fast-math flags or
    approximate intrinsics (the update is the plain version's bits)."""
    src = (build.CSRC / "adamw.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"\batomic\w*\s*\(", code)
    for word in ("fast_math", "fast-math", "__fdividef", "__frcp", "rsqrt",
                 "__expf", "fmaf"):
        assert word not in code
    for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn",
               "__fsqrt_rn"):
        assert op in code
    assert not any("fast" in flag for flag in build.NVCC_FLAGS)
