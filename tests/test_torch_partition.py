"""The port's mesh layer and partition rules on the CPU, held against the
JAX package.

Specs need no processes: for every config of ``ARCHS`` at full size the
port's parameters on the ``meta`` device and the reference's from
``jax.eval_shape``, at the two production meshes given as sizes (the
port's mapping, the reference's ``AbstractMesh``), with and without
FSDP. Every parameter, ZeRO-1, batch and cache spec of the port equals
the reference's base spec (a stacked leaf's without its leading
``None``: the port keeps one layer per layer), exactly.

Placement runs on gloo ranks (``spawn_cpu_ranks``, each spawn under a
deadline that kills its ranks): ``shard`` then ``gather`` gives the
tensor back bit for bit; a checkpoint written by 8 ranks under (2, 4)
restores on 4 ranks under (2, 2) bit for bit, each rank reading its
slices; ``permute_expert_params`` equals the reference's. JAX is
imported inside the tests, so the spawned ranks import torch alone.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.mesh import (check_tensors, make_mesh,
                                     make_production_mesh, mesh_coords,
                                     spawn_cpu_ranks)
from repro_torch.models import block_plan, init_cache, init_params
from repro_torch.models.convert import reference_key
from repro_torch.sharding import (MeshAxes, Partitioner, Shardings, Spec,
                                  gather, permute_expert_params, shard)

MESHES = {"16x16": ((16, 16), ("data", "model"), ("data",)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      ("pod", "data"))}
DEADLINE = 90.0                  # seconds a spawn may take before its kill


def parts(mesh_name, fsdp):
    """(port Partitioner, reference Partitioner) at a production mesh."""
    from repro.sharding.partition import MeshAxes as JaxAxes
    from repro.sharding.partition import Partitioner as JaxPartitioner
    from repro.sharding.partition import abstract_mesh
    shape, axes, data = MESHES[mesh_name]
    port = Partitioner(dict(zip(axes, shape)), MeshAxes(data, "model", fsdp))
    ref = JaxPartitioner(abstract_mesh(shape, axes),
                         JaxAxes(data, "model", fsdp))
    return port, ref


def lookup(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def base(ref_spec, stacked):
    spec = tuple(ref_spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


@pytest.fixture(scope="module")
def reference_shapes():
    """Each config's reference parameter shapes (``jax.eval_shape`` of
    its ``init_params``) and cache shapes at B=32, T=256."""
    import jax

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.launch.specs import abstract_params
    from repro.models.model import init_cache as jax_init_cache
    return {name: (abstract_params(cfg),
                   jax.eval_shape(lambda c=cfg: jax_init_cache(c, 32, 256)))
            for name, cfg in JAX_ARCHS.items()}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_zero1_specs_equal_the_reference(reference_shapes,
                                                   mesh_name, fsdp):
    from jax.sharding import PartitionSpec as P
    port, ref = parts(mesh_name, fsdp)
    assert sorted(ARCHS) == sorted(reference_shapes)
    n = 0
    for name, cfg in ARCHS.items():
        model = init_params(cfg, torch.Generator(), device="meta")
        ref_specs = ref.param_specs(reference_shapes[name][0])
        got = port.param_specs(model)
        for pname, p in model.named_parameters():
            path, rep = reference_key(pname, cfg)
            stacked = rep is not None
            want = base(lookup(ref_specs, path), stacked)
            assert isinstance(got[pname], Spec)
            assert tuple(got[pname]) == want, (name, pname, got[pname], want)
            shape = tuple(p.shape)
            assert tuple(port.zero1_spec(got[pname], shape)) == \
                tuple(ref.zero1_spec(P(*want), shape)), (name, pname)
            n += 1
    assert n > 1000


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_the_reference(reference_shapes,
                                                   mesh_name):
    port, ref = parts(mesh_name, False)
    for b in (1, 2, 8, 16, 24, 32, 64, 96, 512):
        for shape in ((b, 128), (b, 128, 64)):
            assert tuple(port.batch_spec(shape)) == \
                tuple(ref.batch_spec(shape)), shape
        assert port.dp_axes_for_batch(b) == ref.dp_axes_for_batch(b)
    for name, cfg in ARCHS.items():
        cache = init_cache(cfg, 32, 256, device="meta")
        ref_specs = ref.cache_specs(reference_shapes[name][1])
        got = port.cache_specs(cache)
        assert len(got) == len(cache) == len(block_plan(cfg))
        for (what, i), block, specs in zip(block_plan(cfg), cache, got):
            for leaf, t in block.items():
                if what == "shared":
                    path, stacked = f"groups/shared/{leaf}", True
                else:
                    path, rep = reference_key(f"layers.{i}.{leaf}", cfg)
                    stacked = rep is not None
                want = base(lookup(ref_specs, path), stacked)
                assert tuple(specs[leaf]) == want, (name, what, i, leaf)
                assert tuple(port.cache_spec(leaf, tuple(t.shape))) == want


def test_specs_pickle_and_compare_as_tuples():
    import pickle
    s = Spec(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s
    assert isinstance(pickle.loads(pickle.dumps(s)), Spec)


def test_permute_expert_params_equals_the_reference():
    import jax

    from repro.sharding.partition import permute_expert_params as jax_permute
    from test_torch_models import model_configs, reference_weights
    from repro_torch.models import params_from_reference
    jax_cfg, cfg = model_configs("qwen3-moe-235b-a22b")
    tree = reference_weights(jax_cfg, seed=3)
    perm = list(np.random.default_rng(4).permutation(cfg.n_experts))
    want = params_from_reference(
        jax.tree.map(np.asarray, jax_permute(tree, perm)), cfg)
    got = permute_expert_params(params_from_reference(tree, cfg), perm)
    moved = 0
    for (name, a), (_, b) in zip(got.named_parameters(),
                                 want.named_parameters()):
        assert torch.equal(a, b), name
        moved += ".moe." in name
    assert moved == 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

ROUND_TRIP = [(Spec(("data", "model"), None), (8, 6)),
              (Spec("model", "data"), (4, 6, 3)),
              (Spec(None, "data", None), (3, 4, 5)),
              (Spec(None, ("model", "data")), (2, 8)),
              (Spec(None, None), (5, 7)),
              (Spec(), (6,))]


def round_trip_rank(rank):
    """Every rank: shard then gather each case; the slice each rank holds
    is its row-major chunk. Then the refusals."""
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    at = mesh_coords(mesh)
    out = []
    for spec, shape in ROUND_TRIP:
        full = torch.arange(math.prod(shape), dtype=torch.float32) \
            .reshape(shape) * 1.5
        local = shard(full, spec, mesh)
        out.append((tuple(local.shape), torch.equal(gather(local, spec, mesh),
                                                   full)))
    refusals = []
    try:
        make_mesh((2, 4), ("data", "model"), device_type="cpu")
    except RuntimeError as e:
        refusals.append(str(e))
    try:
        check_tensors(mesh, torch.empty(2, device="meta"))
    except ValueError as e:
        refusals.append(str(e))
    try:
        make_mesh((2, 2), ("data", "model"))            # cuda on gloo
    except ValueError as e:
        refusals.append(str(e))
    return at, out, refusals


def test_shard_then_gather_is_bit_exact_on_four_gloo_ranks():
    for at, out, refusals in spawn_cpu_ranks(4, round_trip_rank,
                                             timeout=DEADLINE):
        for (spec, shape), (local, same) in zip(ROUND_TRIP, out):
            assert same, (at, spec)
            sizes = {"data": 2, "model": 2}
            want = [d // math.prod(sizes[a] for a in
                                   ((spec[i],) if isinstance(spec[i], str)
                                    else spec[i] or ()))
                    if i < len(spec) else d for i, d in enumerate(shape)]
            assert list(local) == want, (spec, local)
        assert "need 8 ranks, have 4" in refusals[0]
        assert "start 8 processes" in refusals[0]
        assert "meta tensor under a cpu mesh" in refusals[1]
        assert "needs a nccl process group" in refusals[2]
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh(device_type="cpu")


def elastic_state(cfg, part, mesh, template=False):
    """{"params": {name: slice}, "opt": {"m": {name: slice}}} of the
    model from seed 0 (``m`` its parameters doubled) under the
    partitioner's param and ZeRO-1 specs, and the specs' tree; with
    ``template`` the slices are zeros."""
    model = init_params(cfg, torch.Generator().manual_seed(0))
    specs = {"params": {}, "opt": {"m": {}}}
    state = {"params": {}, "opt": {"m": {}}}
    for name, p in model.named_parameters():
        ps = part.param_spec(name, tuple(p.shape))
        zs = part.zero1_spec(ps, tuple(p.shape))
        specs["params"][name], specs["opt"]["m"][name] = ps, zs
        for tree, spec, full in ((state["params"], ps, p.detach()),
                                 (state["opt"]["m"], zs, 2 * p.detach())):
            local = shard(full, spec, mesh)
            tree[name] = torch.zeros_like(local) if template else local
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    return state, specs


def elastic_rank(rank, directory, shape, write):
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    cfg = reduced(ARCHS["qwen3-moe-235b-a22b"]).replace(dtype="float32")
    part = Partitioner(mesh, MeshAxes())
    mgr = CheckpointManager(directory, async_save=False)
    if write:
        state, specs = elastic_state(cfg, part, mesh)
        mgr.save(state, 5, shardings=Shardings(mesh, specs))
        return None
    want, specs = elastic_state(cfg, part, mesh)
    got, _ = elastic_state(cfg, part, mesh, template=True)
    mgr.restore(got, 5, shardings=Shardings(mesh, specs))
    flat_got, flat_want = ckpt._flatten(got), ckpt._flatten(want)
    sharded = sum(any(e is not None for e in s)
                  for s in ckpt._flatten(specs).values())
    return ({k: torch.equal(flat_got[k], flat_want[k]) for k in flat_want},
            {k: tuple(v.shape) for k, v in flat_got.items()}, sharded)


def test_checkpoint_written_on_8_ranks_restores_on_4_bit_for_bit(tmp_path):
    """The elastic restart: a state sharded under (2, 4) saved (each leaf
    gathered, rank 0 writes) and restored under (2, 2), each rank reading
    only its slices, equal bit for bit to the slices of the same state
    under (2, 2), in the local shapes of the new mesh."""
    spawn_cpu_ranks(8, elastic_rank, str(tmp_path), (2, 4), True,
                    timeout=DEADLINE)
    cfg = reduced(ARCHS["qwen3-moe-235b-a22b"]).replace(dtype="float32")
    whole = dict(init_params(cfg, torch.Generator().manual_seed(0))
                 .named_parameters())
    small = Partitioner({"data": 2, "model": 2}, MeshAxes())
    for same, shapes, sharded in spawn_cpu_ranks(
            4, elastic_rank, str(tmp_path), (2, 2), False, timeout=DEADLINE):
        assert all(same.values()), [k for k, v in same.items() if not v]
        assert sharded > 10
        for name, p in whole.items():
            spec = small.param_spec(name, tuple(p.shape))
            want = tuple(d // (2 if i < len(spec) and spec[i] else 1)
                         for i, d in enumerate(p.shape))
            assert shapes[f"params/{name}"] == want, name
        assert shapes["opt/step"] == ()
    npz = tmp_path / "step_00000005" / "state.npz"
    import zipfile
    with zipfile.ZipFile(npz) as z:
        info = z.getinfo("params/layers.0.moe.wi.npy")
    member = ckpt._member(str(npz), info)
    assert isinstance(member, np.memmap)
    assert member.shape == tuple(whole["layers.0.moe.wi"].shape)
