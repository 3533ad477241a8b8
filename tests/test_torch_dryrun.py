"""The port's eager cost analysis (``launch/op_analysis.py``, the
reference's ``launch/hlo_analysis.py``) and dry-run (``launch/dryrun.py``)
on the CPU, in one process playing rank 0 of a ``fake`` world.

The analyser counts what a call runs: a chain of matmuls exactly, the
collectives a rank hands its groups. The dry-run's per-rank parameter,
moment and cache bytes equal the per-device bytes the reference's
``Partitioner`` specs give on its ``abstract_state`` over an abstract
mesh of the same shape (nothing compiled), and sit where the card's
measurements put them."""

import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.op_analysis import analyze_call, fake_mode, record
from repro_torch.launch.specs import (TensorSpec, abstract, abstract_params,
                                      abstract_state, mesh_axes_for, sds)

MESHES = {(1, 4): ("data", "model"), (4, 1): ("data", "model")}


# ---------------------------------------------------------------------------
# the analyser
# ---------------------------------------------------------------------------

def test_analyzer_counts_every_matmul_of_a_chain():
    """The counterpart of the reference's trip-count test: a chain of 9
    (128 x 128) matmuls counts exactly 2 * 128^3 * 9 dot FLOPs (eager
    code runs its loop; there is no trip count to recover), and its
    traffic is each product's operands and result."""
    w = torch.zeros((128, 128))

    def chain(x):
        for _ in range(9):
            x = x @ w
        return x

    cost = analyze_call(chain, torch.zeros((128, 128)))
    assert cost.dot_flops == 2 * 128 ** 3 * 9
    assert cost.traffic_bytes == 9 * 3 * 128 * 128 * 4
    assert cost.n_ops == 9 and cost.collective_total == 0
    assert cost.top_dots[0][0] == 2 * 128 ** 3


def test_analyzer_on_fake_tensors_and_a_fake_world():
    """Views cost nothing, copies count; a rank's collectives are counted
    by the reference's opcode names, a send as a permute, and by group."""
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with fake_mode():
            x = torch.zeros((64, 32))

            def fn(x):
                y = x.t().contiguous()               # a view, then a copy
                dist.all_reduce(y, group=mesh.get_group("model"))
                dist.all_reduce(y, group=mesh.get_group("data"))
                if dist.get_rank() == 0:
                    dist.send(y, 1)
                return y

            cost = analyze_call(fn, x)
    nbytes = 64 * 32 * 4
    assert cost.collective_bytes == {"all-reduce": 2 * nbytes,
                                     "collective-permute": nbytes}
    assert cost.collective_groups[(0, 1)] == nbytes      # model of rank 0
    assert cost.collective_groups[(0, 2)] == nbytes      # data of rank 0
    assert cost.traffic_bytes >= 2 * nbytes               # the copy
    assert not dist.is_initialized()


def test_a_host_read_of_a_fake_position_is_answered_and_still_checked():
    """A fake tensor cannot answer ``.tolist()``; the recorder answers
    the small integer tensors the call made from host values, so the
    ``flash_decode`` range guard reads the real positions and still
    refuses one past the cache."""
    from repro_torch.models.layers import attention_decode
    with fake_mode():
        q = torch.zeros((2, 1, 4, 16))
        kv = torch.zeros((2, 8, 2, 16))
        ok = analyze_call(attention_decode, q, kv, kv, pos=7,
                          answer_reads=True)
        assert ok.dot_flops > 0
        with pytest.raises(IndexError, match="positions span"):
            analyze_call(attention_decode, q, kv, kv, pos=8,
                         answer_reads=True)
        with pytest.raises(Exception):       # nobody answers it
            record(attention_decode, q, kv, kv, pos=7)


def test_abstract_state_holds_no_storage():
    cfg = ARCHS["gemma2-2b"]
    params = abstract_params(cfg)
    state = abstract_state(cfg)
    n = sum(p.numel() for p in params.parameters())
    assert n == sum(p.numel() for p in state["params"].parameters())
    assert set(state["opt"]) == {"m", "v", "step"}
    w = state["opt"]["m"]["embed"]
    assert type(w).__name__ == "FakeTensor" and w.dtype == torch.float32
    assert abstract(lambda t: t * 2, w).shape == w.shape
    assert sds([2, 3], torch.int64) == TensorSpec((2, 3), torch.int64)


# ---------------------------------------------------------------------------
# per-rank bytes against the reference's specs
# ---------------------------------------------------------------------------

def _ref_bytes(cfg_name, shape_name, mesh_shape, fsdp, n_layers=None):
    """Per-device parameter, moment and cache bytes by the reference's
    specs on its abstract state (no compile). ``moment_bytes`` applies
    the reference's ``zero1_spec`` to each layer's leaf, as the port
    keeps one tensor a layer; ``moment_bytes_stacked`` to the stacked
    leaf, where ZeRO-1 may also put ``data`` on the layer-stack dim,
    which the port's leaves do not have."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.launch.specs import abstract_state as ref_abstract_state
    from repro.launch.specs import input_specs as ref_input_specs
    from repro.sharding.partition import MeshAxes as JaxAxes
    from repro.sharding.partition import Partitioner as JaxPartitioner
    from repro.sharding.partition import abstract_mesh
    cfg = REF_ARCHS[cfg_name]
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    axes = MESHES[mesh_shape]
    sizes = dict(zip(axes, mesh_shape))
    part = JaxPartitioner(abstract_mesh(mesh_shape, axes),
                          JaxAxes(("data",), "model", fsdp))

    def local(leaf, spec, itemsize=None):
        n = leaf.size
        for entry in spec:
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                n //= sizes[a]
        return n * (itemsize or leaf.dtype.itemsize)

    out = {"param_bytes": 0, "moment_bytes": 0, "cache_bytes": 0}
    shape = REF_SHAPES[shape_name]
    if shape.mode == "train":
        params = ref_abstract_state(cfg)["params"]
        specs = part.param_specs(params)
        leaves = jax.tree_util.tree_flatten_with_path(params)[0]
        pspecs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        out["moment_bytes_stacked"] = 0
        for (path, leaf), spec in zip(leaves, pspecs):
            out["param_bytes"] += local(leaf, spec)
            out["moment_bytes_stacked"] += 2 * local(
                leaf, part.zero1_spec(spec, leaf.shape), 4)
            key = jax.tree_util.keystr(path)
            if "groups" in key or "shared_lora" in key:   # (n, ...) stacked
                layer = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                z = part.zero1_spec(jax.sharding.PartitionSpec(*spec[1:]),
                                    layer.shape)
                out["moment_bytes"] += 2 * leaf.shape[0] * local(layer, z, 4)
            else:
                out["moment_bytes"] += 2 * local(
                    leaf, part.zero1_spec(spec, leaf.shape), 4)
    elif shape.mode == "decode":
        cache = ref_input_specs(cfg, shape)["cache"]
        cspecs = jax.tree.leaves(part.cache_specs(cache), is_leaf=lambda x:
                                 isinstance(x, jax.sharding.PartitionSpec))
        out["cache_bytes"] = sum(local(leaf, spec) for leaf, spec in
                                 zip(jax.tree.leaves(cache), cspecs))
    return out


def _lower(arch, shape_name, mesh_shape, **kw):
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        cell = dryrun.lower_cell(arch, shape_name, mesh, **kw)
        fsdp = mesh_axes_for(cell["cfg"], mesh).fsdp
    return cell, fsdp


@pytest.mark.parametrize("arch,shape,mesh_shape", [
    ("zamba2-7b", "train_4k", (1, 4)),
    ("deepseek-v2-lite-16b", "train_4k", (1, 4)),
    ("gemma2-2b", "train_4k", (4, 1)),
    ("mamba2-780m", "train_4k", (4, 1)),
    ("glm4-9b", "decode_32k", (1, 4)),
    ("deepseek-v2-lite-16b", "decode_32k", (4, 1)),
    ("gemma2-2b", "long_500k", (1, 4)),
])
def test_per_rank_bytes_are_the_references_specs(arch, shape, mesh_shape):
    """Exactly the reference's bytes. One layout differs by design: where
    a stacked leaf's own dims are all taken (mamba2's ``dt_bias``,
    ``A_log``, ``D`` and ``gate_norm`` under a model axis of 1), the
    reference's ZeRO-1 cuts its moments over the layer-stack dim and the
    port keeps them whole a layer (mamba2-780m at (4, 1): 926,208 bytes
    more a rank, 0.06 %)."""
    cell, fsdp = _lower(arch, shape, mesh_shape, grad_accum=1)
    want = _ref_bytes(arch, shape, mesh_shape, fsdp)
    stacked = want.pop("moment_bytes_stacked", None)
    got = {k: cell["memory"][k] for k in want}
    if SHAPES[shape].mode != "train":
        want["param_bytes"] = got["param_bytes"]   # compared in training
    assert got == want
    if stacked is not None:
        assert stacked <= got["moment_bytes"] <= 1.001 * stacked
        if (arch, mesh_shape) == ("mamba2-780m", (4, 1)):
            assert got["moment_bytes"] - stacked == 926_208


def test_reckoned_bytes_beside_the_cards_measurements():
    """glm4-9b's ``decode_32k`` cache at (1, 4) is 42.95 GB a GPU (found
    by shapes); the training state (parameters, moments, gradients) of
    zamba2-7b whole at (1, 4) and of gemma2-2b at (4, 1), at the
    ``grad_accum`` 1 those runs took, lies under the peaks measured on
    H100s: 29.52 GB and 14.19 GB a GPU."""
    cell, _ = _lower("glm4-9b", "decode_32k", (1, 4))
    assert round(cell["memory"]["cache_bytes"] / 1e9, 2) == 42.95
    for arch, mesh_shape, peak in (("zamba2-7b", (1, 4), 29.52e9),
                                   ("gemma2-2b", (4, 1), 14.19e9)):
        m = _lower(arch, "train_4k", mesh_shape, grad_accum=1)[0]["memory"]
        state = m["param_bytes"] + m["moment_bytes"] + m["grad_bytes"]
        assert 0.3 * peak < state < peak, (arch, state / 1e9)


# ---------------------------------------------------------------------------
# the dry-run itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,mesh_shape", [
    ("gemma2-2b", "train_4k", (4, 1)),
    ("deepseek-v2-lite-16b", "train_4k", (1, 4)),
    ("zamba2-7b", "decode_32k", (1, 4)),
    ("qwen3-moe-235b-a22b", "prefill_32k", (4, 1)),
])
def test_dryrun_cell_records_rank_zero_at_a_cut_depth(arch, shape,
                                                      mesh_shape):
    n_layers = 6 if arch == "zamba2-7b" else 2
    with fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        rec = dryrun.dryrun_cell(arch, shape, mesh, grad_accum=2,
                                 n_layers=n_layers)
    assert not dist.is_initialized()
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["roofline_seconds"]) == {"compute", "memory",
                                            "collective"}
    assert rec["dominant"] in rec["roofline_seconds"]
    assert 0 < rec["useful_flops_ratio"] < 2
    mem = rec["memory_analysis"]
    assert mem["step_peak_bytes"] > mem["param_bytes"] > 0
    for axis, row in rec["collective_by_axis"].items():
        assert axis in MESHES[mesh_shape]
        assert row["link"] == "nvlink"       # 4 ranks: one 8-GPU node
    model_n = dict(zip(MESHES[mesh_shape], mesh_shape))["model"]
    if model_n > 1:
        assert rec["collective_by_axis"]["model"]["bytes"] > 0
    if SHAPES[shape].mode == "train":
        assert rec["grad_accum"] == 2 and mem["moment_bytes"] > 0
    ref = _ref_bytes(arch, shape, mesh_shape,
                     mesh_axes_for(ARCHS[arch].replace(n_layers=n_layers),
                                   dict(zip(MESHES[mesh_shape],
                                            mesh_shape))).fsdp,
                     n_layers=n_layers)
    if SHAPES[shape].mode == "train":
        assert (mem["param_bytes"], mem["moment_bytes"]) == \
            (ref["param_bytes"], ref["moment_bytes"])
    elif SHAPES[shape].mode == "decode":
        assert mem["cache_bytes"] == ref["cache_bytes"]


def test_cli_runs_a_cell_on_the_production_mesh_and_honours_skips(
        tmp_path, capsys):
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert capsys.readouterr().out.startswith("SKIP hubert-xlarge")
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert capsys.readouterr().out.startswith("OK gemma-2b x decode_32k "
                                              "[16x16]")
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "gemma-2b_decode_32k_16x16.json")
                     .read_text())
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    # 16 model ranks span two 8-GPU nodes: every axis crosses InfiniBand
    assert {r["link"] for r in rec["collective_by_axis"].values()} \
        == {"infiniband"}
    assert rec["memory_analysis"]["fits_h100_80gb"]
    assert np.isfinite(rec["roofline_seconds"]["compute"])
