"""MoE's expert-parallel dispatches (``a2a``, ``local``) on gloo ranks,
held against the dense dispatch and the JAX package.

At the reference tests' sizes (x (4, 16, 16), E 8, F 32, top-2) on a (2,
4) ``("data", "model")`` mesh of 8 ranks: ``moe_a2a`` at capacity 8.0
and ``moe_local_decode`` equal ``moe_dense`` within 2e-5 (float32; the
same products, summed in another order); at a tight capacity (0.5) the
port equals the reference's own ``moe_a2a``, run in a JAX subprocess on
8 forced host devices as ``tests/test_sharding.py`` does, within 2e-5,
with the same copies dropped, and its ``aux`` within 1e-6. On 4 ranks
the gradients of x, the router, ``wi`` and ``wo`` through ``moe_a2a``
equal the dense dispatch's within 2e-5 of the largest (the shards
gathered, the data-parallel shards' gradients summed, as a trainer
does); with the load-balancing loss added, the gradients through
``moe_a2a`` and ``moe_local_decode`` equal the reference's ``jax.grad``
of its own dispatch within 2e-5 of the largest. Reduced qwen3-moe and
deepseek in float32 under (1, 4) and (2, 2), the capacity raised so
nothing drops: the train-mode logits, the prefill and a decode step
equal the single-rank port and the reference's ``forward`` within 1e-4
of the largest logit.

Every spawn runs under a deadline that kills its ranks. JAX is imported
inside the tests, so the spawned ranks import torch alone.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh, mesh_coords, spawn_cpu_ranks
from repro_torch.models import ShardCtx, forward, moe, params_from_reference
from repro_torch.runtime import pad_cache_to
from repro_torch.sharding import MeshAxes, Partitioner, shard_experts

DEADLINE = 120.0
TOL = 2e-5                       # the reference tests' float32 tolerance
F32_REL = 1e-4                   # a whole model, as test_torch_models
D, E, F, K = 16, 8, 32, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def layer_inputs(seed, b=4, s=16):
    """x (B, S, D) N(0, 1), router (D, E) N(0, 0.25), wi, wo N(0, 1) /
    sqrt(fan_in), float32."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((b, s, D)),
        rng.standard_normal((D, E)) * 0.5,
        rng.standard_normal((E, D, 2, F)) / np.sqrt(D),
        rng.standard_normal((E, F, D)) / np.sqrt(F))]


def local_inputs(mesh, arrays, grad=False):
    """This rank's data-parallel rows of x, the router whole, its experts
    of wi and wo: tensors (leaves requiring grad with ``grad``)."""
    at = mesh_coords(mesh)
    dp, ep = mesh.mesh.shape
    x, router, wi, wo = (torch.from_numpy(a) for a in arrays)
    bl, el = x.shape[0] // dp, E // ep
    out = [x[at["data"] * bl:(at["data"] + 1) * bl], router,
           wi[at["model"] * el:(at["model"] + 1) * el],
           wo[at["model"] * el:(at["model"] + 1) * el]]
    return [t.clone().requires_grad_(grad) for t in out]


def layer_rank(rank, shape, cf, arrays, decode_arrays, cotangent):
    """One rank: ``moe_a2a`` at capacity ``cf`` (with the gradient of
    sum(y · cotangent) where a cotangent is given), ``moe_local_decode``
    on ``decode_arrays``; each rank's slices and the mesh coordinates."""
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    kw = dict(top_k=K, activation="swiglu", n_experts=E, mesh=mesh,
              dp_axes=("data",), ep_axis="model")
    grad = cotangent is not None
    x, router, wi, wo = local_inputs(mesh, arrays, grad)
    y, aux = moe.moe_a2a(x, router, wi, wo, capacity_factor=cf, **kw)
    out = {"at": mesh_coords(mesh), "y": y.detach().numpy(),
           "aux": aux.detach().numpy()}
    if grad:
        c = local_inputs(mesh, [cotangent] + arrays[1:])[0]
        (y * c).sum().backward()
        out.update(gx=x.grad.numpy(), grouter=router.grad.numpy(),
                   gwi=wi.grad.numpy(), gwo=wo.grad.numpy())
    if decode_arrays is not None:
        x, router, wi, wo = local_inputs(mesh, decode_arrays)
        y, aux = moe.moe_local_decode(x, router, wi, wo, **kw)
        out.update(y_dec=y.numpy(), aux_dec=aux.numpy())
    return out


def rows(outs, key, dp):
    """The data-parallel shards of ``key`` in order (model rank 0's)."""
    return np.concatenate([next(o[key] for o in outs
                                if o["at"] == {"data": d, "model": 0})
                           for d in range(dp)])


def dense(arrays):
    x, router, wi, wo = (torch.from_numpy(a) for a in arrays)
    return moe.moe_dense(x, router, wi, wo, K, "swiglu")


def test_a2a_and_local_decode_equal_dense_on_8_ranks():
    arrays = layer_inputs(0)
    decode_arrays = layer_inputs(1, s=1)
    outs = spawn_cpu_ranks(8, layer_rank, (2, 4), 8.0, arrays,
                           decode_arrays, None, timeout=DEADLINE)
    assert len({str(o["at"]) for o in outs}) == 8
    for o in outs:                   # the output is whole over the EP axis
        same = next(p for p in outs if p["at"]["data"] == o["at"]["data"])
        np.testing.assert_array_equal(o["y"], same["y"])
    y_ref, _ = dense(arrays)
    np.testing.assert_allclose(rows(outs, "y", 2), y_ref.numpy(),
                               atol=TOL, rtol=TOL)
    y_ref, _ = dense(decode_arrays)
    np.testing.assert_allclose(rows(outs, "y_dec", 2), y_ref.numpy(),
                               atol=TOL, rtol=TOL)
    assert len({float(o["aux"]) for o in outs}) == 1


REFERENCE_A2A = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.models.moe import moe_a2a, moe_dense
    a = np.load("{inp}")
    params = {{k: jnp.asarray(a[k]) for k in ("router", "wi", "wo")}}
    mesh = make_mesh((2, 4), ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda x, p: moe_a2a(
            x, p, top_k={k}, activation="swiglu", n_experts={e},
            capacity_factor={cf}, mesh=mesh, dp_axes=("data",),
            ep_axis="model"))(jnp.asarray(a["x"]), params)
    y_dense, _ = moe_dense(jnp.asarray(a["x"]), params, {k}, "swiglu")
    np.savez("{out}", y=np.asarray(y), aux=np.asarray(aux),
             y_dense=np.asarray(y_dense))
"""


def test_a2a_at_a_tight_capacity_equals_the_reference_a2a(tmp_path):
    """At capacity 0.5 each rank's 8 tokens (2 rows of a 4-token chunk)
    keep int(8 · 2 / 8 · 0.5) = 1 copy an expert and drop the rest: the
    port drops the same copies as the reference (whose output differs
    from the dense dispatch's), and its aux (the mean of the ranks'
    Switch losses) is the reference's."""
    arrays = layer_inputs(2)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **dict(zip(("x", "router", "wi", "wo"), arrays)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(REFERENCE_A2A).format(inp=inp, out=out, k=K, e=E,
                                                 cf=0.5)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    want = np.load(out)
    outs = spawn_cpu_ranks(8, layer_rank, (2, 4), 0.5, arrays, None, None,
                           timeout=DEADLINE)
    got = rows(outs, "y", 2)
    np.testing.assert_allclose(got, want["y"], atol=TOL, rtol=TOL)
    assert np.abs(want["y"] - want["y_dense"]).max() > 0.1   # copies dropped
    for o in outs:
        np.testing.assert_allclose(o["aux"], want["aux"], rtol=1e-6)


def test_a2a_gradients_equal_the_dense_dispatchs_on_4_ranks():
    arrays = layer_inputs(3)
    cot = np.random.default_rng(4).standard_normal((4, 16, D)) \
        .astype(np.float32)
    x, router, wi, wo = (torch.from_numpy(a).requires_grad_()
                         for a in arrays)
    y, _ = moe.moe_dense(x, router, wi, wo, K, "swiglu")
    (y * torch.from_numpy(cot)).sum().backward()
    outs = spawn_cpu_ranks(4, layer_rank, (2, 2), 8.0, arrays, None, cot,
                           timeout=DEADLINE)

    def close(got, want, what):
        want = want.detach().numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL, (what, err)

    close(rows(outs, "gx", 2), x.grad, "x")
    for o in outs:              # summed over EP inside: equal on every rank
        same = next(p for p in outs if p["at"]["data"] == o["at"]["data"])
        np.testing.assert_array_equal(o["grouter"], same["grouter"])
    close(sum(o["grouter"] for o in outs if o["at"]["model"] == 0),
          router.grad, "router")
    for key, w in (("gwi", wi), ("gwo", wo)):
        summed = [sum(o[key] for o in outs if o["at"]["model"] == m)
                  for m in range(2)]
        close(np.concatenate(summed), w.grad, key)


REFERENCE_GRADS = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.models.moe import moe_a2a, moe_local_decode
    a = np.load("{inp}")
    mesh = make_mesh((2, 2), ("data", "model"))
    kw = dict(top_k={k}, activation="swiglu", n_experts={e}, mesh=mesh,
              dp_axes=("data",), ep_axis="model")
    out = {{}}
    for name, fn, extra in (("a2a", moe_a2a, dict(capacity_factor=8.0)),
                            ("dec", moe_local_decode, {{}})):
        def loss(x, p):
            y, aux = fn(x, p, **kw, **extra)
            return jnp.sum(y * a[name + "_c"]) + aux
        params = {{k: jnp.asarray(a[name + "_" + k])
                  for k in ("router", "wi", "wo")}}
        with mesh:
            gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                jnp.asarray(a[name + "_x"]), params)
        out[name + "_gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[name + "_g" + k] = np.asarray(v)
    np.savez("{out}", **out)
"""


def aux_grad_rank(rank, cases):
    """One rank of a (2, 2) mesh: for each dispatch, the gradients of
    sum(y · c) + aux over this rank's rows (as a trainer's per-rank loss)
    with respect to this rank's x rows, the router and its experts."""
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {"at": mesh_coords(mesh)}
    for name, (arrays, cot) in cases.items():
        x, router, wi, wo = local_inputs(mesh, arrays, grad=True)
        c = local_inputs(mesh, [cot] + arrays[1:])[0]
        kw = dict(top_k=K, activation="swiglu", n_experts=E, mesh=mesh,
                  dp_axes=("data",), ep_axis="model")
        if name == "a2a":
            y, aux = moe.moe_a2a(x, router, wi, wo, capacity_factor=8.0,
                                 **kw)
        else:
            y, aux = moe.moe_local_decode(x, router, wi, wo, **kw)
        ((y * c).sum() + aux).backward()
        out.update({f"{name}_g{k}": t.grad.numpy() for k, t in
                    (("x", x), ("router", router), ("wi", wi), ("wo", wo))})
    return out


def test_a2a_and_local_decode_gradients_with_aux_equal_the_reference(
        tmp_path):
    """With the load-balancing loss in the loss (weight 1), the gradients
    through ``moe_a2a`` (capacity 8.0) and ``moe_local_decode`` on a (2,
    2) mesh equal the reference's ``jax.grad`` of the same dispatch under
    its ``shard_map`` on 4 forced host devices, within 2e-5 of the
    largest: each rank's ``aux`` takes 1/(dp · ep) (decode: 1/dp) of the
    mean's gradient, and in decode the experts' gradients to x and the
    router are summed over the expert axis while aux's are not. Every
    rank's loss is its own rows' sum(y · c) plus aux; the data-parallel
    shards' gradients of the router and the experts are summed, as a
    trainer does."""
    cases = {"a2a": (layer_inputs(3), np.random.default_rng(4)
                     .standard_normal((4, 16, D)).astype(np.float32)),
             "dec": (layer_inputs(1, s=1), np.random.default_rng(5)
                     .standard_normal((4, 1, D)).astype(np.float32))}
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **{f"{name}_{k}": v for name, (arrays, cot) in cases.items()
                     for k, v in zip(("x", "router", "wi", "wo", "c"),
                                     arrays + [cot])})
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(REFERENCE_GRADS).format(inp=inp, out=out, k=K,
                                                   e=E)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    want = np.load(out)
    outs = spawn_cpu_ranks(4, aux_grad_rank, cases, timeout=DEADLINE)

    def close(got, key):
        err = np.abs(got - want[key]).max() / np.abs(want[key]).max()
        assert err <= TOL, (key, err)

    for name in cases:
        close(rows(outs, f"{name}_gx", 2), f"{name}_gx")
        close(sum(o[f"{name}_grouter"] for o in outs if o["at"]["model"] == 0),
              f"{name}_grouter")
        for key in (f"{name}_gwi", f"{name}_gwo"):
            close(np.concatenate([sum(o[key] for o in outs
                                      if o["at"]["model"] == m)
                                  for m in range(2)]), key)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

MODELS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
MESH_SHAPES = ((1, 4), (2, 2))
B, S = 4, 8


def model_rank(rank, cases, tokens):
    """Each model under each mesh: this rank's data-parallel rows of the
    train-mode logits, the prefill's and one decode step's."""
    results = {}
    for shape in MESH_SHAPES:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        at = mesh_coords(mesh)
        bl = B // shape[0]
        toks = torch.from_numpy(tokens[at["data"] * bl:(at["data"] + 1) * bl])
        ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
        for name, (tree, cfg) in cases.items():
            model = shard_experts(params_from_reference(tree, cfg),
                                  Partitioner(mesh, MeshAxes()))
            train, _ = forward(model, {"tokens": toks[:, :S]}, cfg, ctx)
            pre, _, cache = forward(model, {"tokens": toks[:, :S]}, cfg,
                                    ctx.with_mode("prefill"))
            cache = pad_cache_to(cfg, cache, bl, S + 1)
            dec, _, _ = forward(model, {"tokens": toks[:, S:], "pos": S,
                                        "cache": cache}, cfg,
                                ctx.with_mode("decode"))
            results[(name, shape)] = (at, [t.detach().numpy()
                                           for t in (train, pre, dec)])
    return results


def test_reduced_moe_models_under_a_mesh_equal_one_rank_and_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.models.model import ShardCtx as JaxCtx
    from repro.models.model import forward as jax_forward
    from repro.runtime.serve_loop import pad_cache_to as jax_pad_cache_to
    from test_torch_models import model_configs, reference_weights

    tokens = np.random.default_rng(5).integers(0, 256, (B, S + 1))
    cases, want = {}, {}
    for name in MODELS:
        jax_cfg, cfg = model_configs(name)
        e = cfg.n_experts
        jax_cfg = jax_cfg.replace(capacity_factor=float(e))
        cfg = cfg.replace(capacity_factor=float(e))     # no copy drops
        tree = reference_weights(jax_cfg, seed=6)
        cases[name] = (tree, cfg)
        one = params_from_reference(tree, cfg)
        toks = torch.from_numpy(tokens)
        train, _ = forward(one, {"tokens": toks[:, :S]}, cfg, ShardCtx())
        pre, _, cache = forward(one, {"tokens": toks[:, :S]}, cfg,
                                ShardCtx(mode="prefill"))
        dec, _, _ = forward(one, {"tokens": toks[:, S:], "pos": S,
                                  "cache": pad_cache_to(cfg, cache, B,
                                                        S + 1)},
                            cfg, ShardCtx(mode="decode"))
        params = jax.tree.map(jnp.asarray, tree)
        jt = jnp.asarray(tokens)
        j_train, _ = jax_forward(params, {"tokens": jt[:, :S]}, jax_cfg,
                                 JaxCtx(mode="train"))
        j_pre, _, j_cache = jax_forward(params, {"tokens": jt[:, :S]},
                                        jax_cfg, JaxCtx(mode="prefill"))
        j_dec, _, _ = jax_forward(
            params, {"tokens": jt[:, S:], "pos": jnp.asarray(S),
                     "cache": jax_pad_cache_to(jax_cfg, j_cache, B, S + 1)},
            jax_cfg, JaxCtx(mode="decode"))
        want[name] = ([t.detach().numpy() for t in (train, pre, dec)],
                      [np.asarray(t) for t in (j_train, j_pre, j_dec)])

    outs = spawn_cpu_ranks(4, model_rank, cases, tokens, timeout=DEADLINE)
    for name in MODELS:
        for shape in MESH_SHAPES:
            got = [np.concatenate([
                next(r[(name, shape)][1][i] for r in outs
                     if r[(name, shape)][0] == {"data": d, "model": 0})
                for d in range(shape[0])]) for i in range(3)]
            for r in outs:          # whole over the EP axis
                at, mine = r[(name, shape)]
                bl = B // shape[0]
                for g, m in zip(got, mine):
                    np.testing.assert_array_equal(
                        m, g[at["data"] * bl:(at["data"] + 1) * bl])
            for ref in want[name]:
                for g, w, what in zip(got, ref, ("train", "prefill",
                                                 "decode")):
                    err = np.abs(g - w).max() / np.abs(w).max()
                    assert err <= F32_REL, (name, shape, what, err)
