"""Shapes and dtypes of every model input, and the execution context and
mesh axes of a (config, shape, mesh) cell, as the reference's
``launch/specs.py``.

Nothing here allocates: parameter counts come from an init on the
``meta`` device, and :func:`input_specs` returns :class:`TensorSpec`
(shape, dtype) pairs in place of the reference's ``ShapeDtypeStruct``
(:func:`sds`). The reference's ``jax.eval_shape`` trees are
:func:`abstract`'s results: the function run on fake CPU tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage), so
:func:`abstract_params` is a :class:`~repro_torch.models.Model` and
:func:`abstract_state` a train state whose tensors hold nothing, which
the dry-run shards and steps as it would real ones.
``mesh`` is a :class:`~torch.distributed.device_mesh.DeviceMesh` or a
mapping from axis name to size, as :class:`~repro_torch.sharding.
Partitioner` takes it; a context made on a mapping names the layout and
executes nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models.model import ShardCtx, init_cache, init_params
from ..optim.adamw import OptConfig, init_opt_state
from ..sharding.partition import MeshAxes, Partitioner
from .mesh import axis_sizes

__all__ = ["TensorSpec", "abstract", "abstract_params", "abstract_state",
           "input_specs", "make_ctx", "mesh_axes_for", "param_count", "sds"]

ATTN_CLAIMS = ("auto", "none", "batch", "seq", "shard_map_seq")
FSDP_BYTES = 4e9           # TP-only bf16 weights a device holds before FSDP


class TensorSpec(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype) -> TensorSpec:
    """The reference's ``ShapeDtypeStruct``: a shape and a dtype."""
    return TensorSpec(tuple(shape), dtype)


def _fake_mode_of(args):
    from torch._guards import detect_fake_mode
    tensors = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            tensors += list(a.parameters())
        elif isinstance(a, torch.Tensor):
            tensors.append(a)
    return detect_fake_mode(tensors)


def abstract(fn, *args, **kw):
    """``fn(*args, **kw)`` on fake CPU tensors, the counterpart of
    ``jax.eval_shape``: run under the fake tensor mode the arguments (or
    the caller's active mode) carry, else a new one, so its tensors have
    shapes and dtypes and no storage."""
    from .op_analysis import fake_mode
    mode = _fake_mode_of(args) or fake_mode()
    with mode:
        return fn(*args, **kw)


def abstract_params(cfg: ModelConfig):
    """The config's model on fake CPU tensors (no weight allocated)."""
    return abstract(init_params, cfg, torch.Generator(), "cpu")


def abstract_state(cfg: ModelConfig, opt_cfg: OptConfig | None = None
                   ) -> dict:
    """A train state ``{"params", "opt"}`` on fake CPU tensors, in one
    fake tensor mode."""
    params = abstract_params(cfg)
    opt = abstract(init_opt_state, params, opt_cfg or OptConfig())
    return {"params": params, "opt": opt}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The model inputs of one (arch, shape) cell: tokens and labels
    int64 (the port's token type), frames and patches float32; for
    decode the token, its position and the cache (one dict of
    :class:`TensorSpec` per block, from :func:`init_cache` on
    ``meta``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        cache = init_cache(cfg, b, s, device="meta")
        return {"tokens": TensorSpec((b, 1), torch.int64),
                "pos": TensorSpec((), torch.int64),
                "cache": [{k: TensorSpec(tuple(t.shape), t.dtype)
                           for k, t in c.items()} for c in cache]}
    if cfg.frontend == "frame_stub":
        return {"frames": TensorSpec((b, s, cfg.d_model), torch.float32),
                "labels": TensorSpec((b, s), torch.int64)}
    if cfg.frontend == "patch_stub":
        st = s - cfg.n_patches
        return {"patches": TensorSpec((b, cfg.n_patches, cfg.d_model),
                                      torch.float32),
                "tokens": TensorSpec((b, st), torch.int64),
                "labels": TensorSpec((b, st), torch.int64)}
    return {"tokens": TensorSpec((b, s), torch.int64),
            "labels": TensorSpec((b, s), torch.int64)}


def param_count(cfg: ModelConfig) -> int:
    """The config's parameter count, from an init on ``meta``."""
    model = init_params(cfg, torch.Generator(), "meta")
    return sum(p.numel() for p in model.parameters())


def make_ctx(cfg: ModelConfig, shape: ShapeConfig, mesh, axes: MeshAxes,
             mode: str | None = None, attn_claim: str = "auto") -> ShardCtx:
    """The reference's ``make_ctx``: the batch's data-parallel axes, and
    how small-head archs (heads that do not divide the model axis, whose
    attention weights stay whole over it) use the model axis for their
    attention activations: ``"shard_map_seq"`` (``attn_claim="auto"``,
    the production default: each model rank takes a contiguous slice of
    the queries against every key), ``"batch"``/``"seq"`` on request
    (where the batch or the sequence divides), or None (``"none"``: the
    attention computed whole on every rank). Decode claims nothing."""
    if attn_claim not in ATTN_CLAIMS:
        raise ValueError(f"attn_claim {attn_claim!r} is not one of "
                         f"{ATTN_CLAIMS}")
    part = Partitioner(mesh, axes)
    dp = part.dp_axes_for_batch(shape.global_batch)
    if attn_claim == "auto":
        attn_claim = "shard_map_seq"
    attn_mode = None
    if attn_claim != "none" and cfg.n_heads and \
            cfg.n_heads % part.model_n and shape.mode != "decode":
        sizes = axis_sizes(mesh)
        dp_prod = 1
        for a in dp:
            dp_prod *= sizes[a]
        if attn_claim == "batch" and \
                (shape.global_batch // max(dp_prod, 1)) % part.model_n == 0:
            attn_mode = "batch"
        elif shape.seq_len % part.model_n == 0:
            attn_mode = attn_claim if attn_claim != "batch" else "seq"
    return ShardCtx(mesh=mesh, dp_axes=dp, model_axis=axes.model,
                    mode=mode or shape.mode, attn_mode=attn_mode)


def mesh_axes_for(cfg: ModelConfig, mesh) -> MeshAxes:
    """Every axis but ``model`` carries data; FSDP whenever the
    tensor-parallel weights alone would exceed about 4 GB a device (2
    bytes a parameter over the model axis)."""
    sizes = axis_sizes(mesh)
    data = tuple(a for a in sizes if a != "model")
    per_dev = 2 * param_count(cfg) / sizes["model"]
    return MeshAxes(data=data, model="model", fsdp=per_dev > FSDP_BYTES)

