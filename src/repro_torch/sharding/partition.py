"""Logical-axis sharding rules: parameter name + shape -> partition spec,
and the placement of a tensor by its spec on a mesh.

Policy, as the reference's (``sharding/partition.py``):

* TP: head / d_ff / expert axes shard over ``model``. When a dim does not
  divide the axis, the weight is replicated over it.
* FSDP (``MeshAxes.fsdp``): the non-TP weight dim also shards over
  ``data``.
* ZeRO-1: optimizer moments take the param spec plus ``data`` on the
  first free divisible axis.
* Activations: batch over the DP axes (pod × data where it divides);
  decode KV caches shard kv-heads over ``model`` where they divide, else
  the sequence axis.

The port's spec type is :class:`Spec`, a tuple with one entry per
leading dim of a tensor: an axis name, a tuple of axis names (the first
major), or ``None``. The port keeps one ``Layer`` per layer, so a layer's
leaf has no stacked leading dim: its spec is the reference's base spec,
without the stacked ``None``. Paths are the port's parameter names
(``layers.3.moe.wi``, ``shared.lora.2.a``); the rules read the last
component, and ``moe`` and ``lora`` anywhere in the path, as the
reference's do.

``mesh`` is a :class:`~torch.distributed.device_mesh.DeviceMesh` or a
mapping from axis name to size (the counterpart of ``AbstractMesh``: the
rules need sizes only). In place of the reference's ``named``,
:func:`shard` gives this rank's slice of a tensor and :func:`gather`
gives the whole tensor back.

What executes under a mesh in this port: every weight of every family
at its spec (:func:`shard_params`: heads, the MLP's F, the vocabulary,
Mamba-2's heads and ``d_inner``, the LoRA's ``b_*``, MLA's ``wkv_b`` and
MoE's experts over ``model``, run by the tensor-parallel blocks of
:mod:`repro_torch.models.blocks`), or MoE's experts alone over ``model``
(:func:`shard_experts`, for the ``a2a`` and ``local`` dispatches) with
every other weight whole. A model kept by :func:`shard_params` decodes
against caches at :meth:`Partitioner.cache_spec`'s layout
(:func:`cache_slices`: kv heads over ``model`` where they divide, else
the slots; MLA's latent over the slots; a Mamba layer's state and
``conv_x`` over heads). Under FSDP
(``MeshAxes.fsdp``) each rank keeps its slice by the whole spec, data
axes included; the model records which parameters carry data axes, on
which dim (``fsdp_dims``), and its forward gathers them over the data
axes a layer at a time (:func:`repro_torch.sharding.collectives.
fsdp_gather`), whose backward reduce-scatters the gradients. ZeRO-1:
:meth:`Partitioner.moment_specs` lays the optimizer moments out by
:meth:`Partitioner.zero1_spec`, and
:func:`repro_torch.optim.adamw.apply_updates` updates each rank's
slice of them.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..launch.mesh import axis_sizes, check_tensors, mesh_coords

__all__ = ["MeshAxes", "Partitioner", "SLOTTED", "Shardings", "Spec",
           "cache_slices", "gather", "permute_expert_params", "shard",
           "shard_experts", "shard_params", "shard_slices", "spec_axes",
           "split_spec"]

#: the decode cache tensors whose dim 1 is the T slots
SLOTTED = ("k", "v", "latent", "k_rope")


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


class Spec(tuple):
    """A partition spec: ``Spec("model", None)`` shards dim 0 over
    ``model``; ``Spec(("pod", "data"))`` shards dim 0 over pod × data,
    pod major. Dims past its length are not sharded. Equal to the tuple
    of its entries; a one-axis tuple entry is stored as its name, as
    ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


class Shardings(NamedTuple):
    """A mesh and a tree of :class:`Spec` (the structure of the state it
    describes, a module's parameters as a ``{name: Spec}`` dict): what
    :meth:`repro_torch.checkpoint.CheckpointManager.restore` reads each
    rank's slices by."""
    mesh: object
    specs: object


@dataclass(frozen=True)
class MeshAxes:
    data: tuple[str, ...] = ("data",)       # DP axes (pod, data) multi-pod
    model: str = "model"
    fsdp: bool = False                      # shard weights over data too

    @property
    def fsdp_axis(self):
        return self.data if self.fsdp else None


def _div(shape, i, n) -> bool:
    return 0 <= i < len(shape) and shape[i] % n == 0 and shape[i] >= n


def _last(path: str) -> str:
    return re.split(r"[./]", path)[-1]


def _walk(tree, leaf, prefix=""):
    """``tree`` with every leaf replaced by ``leaf(path, shape)``: dicts
    and lists are walked, a module's parameters become a ``{name: ...}``
    dict, anything with a ``shape`` is a leaf."""
    if isinstance(tree, torch.nn.Module):
        return {k: leaf(k, tuple(v.shape))
                for k, v in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return leaf(prefix, tuple(tree.shape))


class Partitioner:
    def __init__(self, mesh, axes: MeshAxes):
        self.mesh = mesh
        self.axes = axes
        s = axis_sizes(mesh)
        self.model_n = s[axes.model]
        self.data_n = math.prod(s[a] for a in axes.data)

    # -- helpers ----------------------------------------------------------
    def _model_if(self, shape, i):
        return self.axes.model if _div(shape, i, self.model_n) else None

    def _fsdp_if(self, shape, i):
        a = self.axes.fsdp_axis
        return a if (a and _div(shape, i, self.data_n)) else None

    def _attn_proj(self, shape, d_at, h_at, dh_at):
        """Heads over ``model`` where they divide, else replicated over
        it; FSDP on the model-dim side."""
        spec = [None] * len(shape)
        if _div(shape, h_at, self.model_n):
            spec[h_at] = self.axes.model
        spec[d_at] = self._fsdp_if(shape, d_at)
        return Spec(*spec)

    # -- parameter rules ----------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """The spec of parameter ``path`` (a port parameter name) of
        ``shape``: the reference's base spec."""
        ax = self.axes
        name = _last(path)
        if name == "embed":
            return Spec(self._model_if(shape, 0), self._fsdp_if(shape, 1))
        if name == "head":
            return Spec(self._fsdp_if(shape, 0), self._model_if(shape, 1))
        if name in ("frontend", "patch_proj", "down"):
            return Spec(self._fsdp_if(shape, 0), self._model_if(shape, 1))
        if name in ("wq", "wk", "wv"):
            return self._attn_proj(shape, 0, 1, 2)
        if name == "wo" and len(shape) == 3:     # (H, dh, d); experts' too
            spec = [None, None, self._fsdp_if(shape, 2)]
            if _div(shape, 0, self.model_n):
                spec[0] = ax.model
            return Spec(*spec)
        if name == "wkv_a":                      # (d, L+rope)
            return Spec(self._fsdp_if(shape, 0), None)
        if name == "wkv_b":                      # (L, H, nope+v)
            return Spec(None, self._model_if(shape, 1), None)
        if name == "wi" and len(shape) == 3:     # dense mlp (d, c, F)
            return Spec(self._fsdp_if(shape, 0), None,
                        self._model_if(shape, 2))
        if name == "wo" and len(shape) == 2:     # dense mlp (F, d)
            return Spec(self._model_if(shape, 0), self._fsdp_if(shape, 1))
        if name == "router":
            return Spec(None, None)
        if name == "wi" and len(shape) == 4:     # experts (E, d, 2, F)
            return Spec(self._model_if(shape, 0), self._fsdp_if(shape, 1),
                        None, None)
        # mamba2
        if name in ("wz", "wx"):
            return Spec(self._fsdp_if(shape, 0), self._model_if(shape, 1))
        if name in ("wB", "wC"):
            return Spec(self._fsdp_if(shape, 0), None)
        if name == "wdt":
            return Spec(self._fsdp_if(shape, 0), self._model_if(shape, 1))
        if name in ("dt_bias", "A_log", "D"):
            return Spec(self._model_if(shape, 0))
        if name == "conv_x":
            return Spec(None, self._model_if(shape, 1))
        if name in ("conv_B", "conv_C"):
            return Spec(None, None)
        if name == "gate_norm":
            return Spec(self._model_if(shape, 0))
        if name == "wout":
            return Spec(self._model_if(shape, 0), self._fsdp_if(shape, 1))
        # zamba2 lora
        if name == "a" and "lora" in path:
            return Spec(None, self._fsdp_if(shape, 1), None)
        if name.startswith("b_") and "lora" in path:
            return Spec(None, self._model_if(shape, 1), None)
        # norms / scalars / anything else: replicated
        return Spec(*([None] * len(shape)))

    def param_specs(self, params) -> dict:
        """``{name: Spec}`` of a module's parameters, or the specs of a
        tree of dicts and lists with shaped leaves (paths joined by
        ``/``)."""
        return _walk(params, self.param_spec)

    # -- optimizer state (ZeRO-1) ------------------------------------------
    def zero1_spec(self, pspec: Spec, shape: tuple[int, ...]) -> Spec:
        """Param spec + ``data`` on the first free divisible axis."""
        if self.axes.fsdp:                      # already data-sharded
            return pspec
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        for i, (cur, dim) in enumerate(zip(spec, shape)):
            if cur is None and dim % self.data_n == 0 and dim >= self.data_n:
                spec[i] = self.axes.data
                return Spec(*spec)
        return pspec

    def moment_specs(self, params, specs: dict) -> dict:
        """``{name: Spec}`` of the optimizer moments of ``params`` (a
        module, or ``{name: tensor}`` of whole tensors) whose parameters
        lie at ``specs``: each :meth:`zero1_spec`, as the reference's dry
        run lays them out. With one data rank, the parameter's spec (a
        one-rank axis would slice nothing)."""
        named = dict(params.named_parameters()) \
            if isinstance(params, torch.nn.Module) else dict(params)
        if self.data_n == 1:
            return dict(specs)
        return {k: self.zero1_spec(specs[k], tuple(p.shape))
                for k, p in named.items()}

    # -- activations / batch -------------------------------------------------
    def dp_axes_for_batch(self, batch: int) -> tuple[str, ...]:
        """Largest prefix of the DP axes whose product divides the batch."""
        axes, prod = [], 1
        s = axis_sizes(self.mesh)
        for a in self.axes.data:
            if batch % (prod * s[a]) == 0:
                axes.append(a)
                prod *= s[a]
        return tuple(axes)

    def batch_spec(self, shape: tuple[int, ...]) -> Spec:
        dp = self.dp_axes_for_batch(shape[0])
        return Spec(dp if dp else None, *([None] * (len(shape) - 1)))

    def cache_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """KV / state cache specs; ``path`` ends with the leaf's name
        (``k``, ``v``, ``latent``, ``k_rope``, ``state``, ...)."""
        name = _last(path)
        dp = self.dp_axes_for_batch(shape[0]) or None
        if name in ("k", "v"):                   # (B, T, Hkv, dh)
            if _div(shape, 2, self.model_n):
                return Spec(dp, None, self.axes.model, None)
            if _div(shape, 1, self.model_n):     # shard sequence
                return Spec(dp, self.axes.model, None, None)
            return Spec(dp, None, None, None)
        if name == "state":                      # (B, H, P, N)
            return Spec(dp, self._model_if(shape, 1), None, None)
        if name == "conv_x":                     # (B, K-1, d_inner)
            return Spec(dp, None, self._model_if(shape, 2))
        if name in ("conv_B", "conv_C"):
            return Spec(dp, None, None)
        if name in ("latent", "k_rope"):         # (B, T, .): seq-shard
            return Spec(dp, self._model_if(shape, 1), None)
        return Spec(dp, *([None] * (len(shape) - 1)))

    def cache_specs(self, cache) -> list:
        """The specs of a cache (:func:`repro_torch.models.init_cache`'s
        list of dicts), in its structure."""
        return _walk(cache, self.cache_spec)


# ---------------------------------------------------------------------------
# placement: a rank's slice of a tensor, and the tensor from the slices
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _chunk(coords: dict, sizes: dict, axes: tuple[str, ...]) -> tuple:
    """(index, count) of the chunk ``coords`` holds of a dim sharded over
    ``axes``, row-major (the first axis major)."""
    index, count = 0, 1
    for a in axes:
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


def _slices(shape, spec, coords, sizes) -> tuple:
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(spec[i]) if i < len(spec) else ()
        index, count = _chunk(coords, sizes, axes)
        if dim % count:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({count})")
        n = dim // count
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)


def shard_slices(shape, spec, mesh) -> tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that this rank holds under
    ``spec`` on ``mesh``."""
    return _slices(shape, spec, mesh_coords(mesh), axis_sizes(mesh))


def shard(tensor: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``tensor`` under ``spec`` on ``mesh``: a
    contiguous copy."""
    check_tensors(mesh, tensor)
    return tensor[shard_slices(tensor.shape, spec, mesh)].clone(
        memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from each rank's slice ``local`` under ``spec``
    (the inverse of :func:`shard`): an all-gather over each axis of the
    spec, so every rank that shares the other axes calls it. A dim split
    over several axes gathers the last (minor) first, so each gather
    joins contiguous blocks."""
    check_tensors(mesh, local)
    full = local
    for i, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):
            group = mesh.get_group(axis)
            pieces = [torch.empty_like(full)
                      for _ in range(dist.get_world_size(group))]
            dist.all_gather(pieces, full.contiguous(), group=group)
            full = torch.cat(pieces, dim=i)
    return full.clone() if full is local else full


def _moe_modules(model):
    return [(name, m) for name, m in model.named_modules()
            if name.split(".")[-1] == "moe"]


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis ``spec`` shards some dim over, in order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def split_spec(spec, data: tuple[str, ...]) -> tuple[dict, Spec]:
    """``spec`` split into ``{dim: axes}`` of the dims it shards over the
    data axes ``data`` and the spec without them (its tensor-parallel
    part): what FSDP gathers, and the layout it gathers to. A dim split
    over data and other axes alike is refused: gathering its data part
    would not join contiguous blocks."""
    dims, rest = {}, []
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        mine = tuple(a for a in axes if a in data)
        if mine and len(mine) != len(axes):
            raise ValueError(f"spec {spec}: dim {i} is split over data "
                             f"axes and others alike {axes}")
        if mine:
            dims[i] = mine
        rest.append(None if mine else entry)
    return dims, Spec(*rest)


def _keep_local(model, part: Partitioner, names) -> None:
    """Replace each parameter of ``names`` that its spec shards by this
    rank's slice of it, keeping ``requires_grad``; record in
    ``model.fsdp_dims`` (``{name: (dim, data axes)}``) each one whose
    spec shards a dim over the data axes, which the forward gathers."""
    fsdp = dict(getattr(model, "fsdp_dims", {}))
    for name in names:
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix)
        w = getattr(owner, leaf)
        spec = part.param_spec(name, tuple(w.shape))
        if not spec_axes(spec):
            continue
        dims, _ = split_spec(spec, part.axes.data)
        if len(dims) > 1:
            raise ValueError(f"{name}: spec {spec} shards {len(dims)} dims "
                             f"over the data axes")
        fsdp.update({name: (i, axes) for i, axes in dims.items()})
        owner.register_parameter(leaf, torch.nn.Parameter(
            shard(w.detach(), spec, part.mesh),
            requires_grad=w.requires_grad))
    model.fsdp_dims = fsdp


def shard_params(model, part: Partitioner):
    """Keep this rank's slice of every parameter of ``model`` (a
    :class:`~repro_torch.models.Model` of any family) by
    :meth:`Partitioner.param_spec`: attention heads (MLA's ``wkv_b`` and
    zamba2's LoRA ``b_*`` with them), the MLP's F (MoE's shared experts
    too), MoE's experts (as :func:`shard_experts` keeps them), Mamba-2's
    heads and ``d_inner`` columns, the vocabulary and the frontends'
    output columns over ``model`` where they divide, the rest whole. In
    place; returns the model, which the tensor-parallel blocks then run
    (:mod:`repro_torch.models.blocks`). Under FSDP the weights' other
    dim is also cut over the data axes (``model.fsdp_dims`` records it),
    and the forward gathers it back a layer at a time. The model records
    ``part`` (``model.partitioner``) and marks its attention modules
    ``caches_by_spec``: its decode caches lie at
    :meth:`Partitioner.cache_spec`'s layout (:func:`cache_slices`). A
    Mamba-2 split whose ranks' heads would cut a group of B and C is
    refused."""
    from ..models.blocks import ssm_groups
    cfg = model.cfg
    if cfg.ssm_state and cfg.ssm_heads % part.model_n == 0:
        heads = cfg.ssm_heads // part.model_n
        for r in range(part.model_n):
            ssm_groups(cfg.ssm_heads, cfg.ssm_ngroups, heads, r)
    _keep_local(model, part, [k for k, _ in model.named_parameters()])
    model.partitioner = part
    for name, m in model.named_modules():
        if name.split(".")[-1] == "attn":
            m.caches_by_spec = True
    return model


def cache_slices(part: Partitioner, path: str,
                 shape: tuple[int, ...]) -> tuple[slice, ...]:
    """This rank's slices of a decode cache tensor ``path`` (ending in
    its name) of whole ``shape``, held by one data-parallel rank (its
    batch rows already): the model-axis entries of
    :meth:`Partitioner.cache_spec`. A K/V cache whose kv heads do not
    divide the model axis, and MLA's ``latent``/``k_rope``, are cut over
    their T slots; a T that does not divide is refused (the reference
    would keep such a cache whole; the port's decode reads a cut one)."""
    model = part.axes.model
    spec = Spec(*(e if e == model else None
                  for e in part.cache_spec(path, shape)))
    name = _last(path)
    by_slots = name in SLOTTED and (name in ("latent", "k_rope")
                                    or shape[2] % part.model_n != 0)
    if by_slots and spec[1] != model:
        raise ValueError(f"{path}: a cache of {shape[1]} slots does not "
                         f"split over {part.model_n} model ranks; give a "
                         f"length that divides")
    return shard_slices(shape, spec, part.mesh)


def shard_experts(model, part: Partitioner):
    """Keep each MoE layer's expert weights (``wi``, ``wo``) as this
    rank's slice over ``model``, by the partitioner's expert rule; every
    other weight stays whole: :func:`shard_params`' MoE case, the layout
    MoE's ``a2a`` and ``local`` dispatches read (ROADMAP A13d). Under
    FSDP the experts' model dim is also cut over the data axes and
    gathered in their layer. In place; returns the model."""
    _keep_local(model, part, [f"{name}.{k}" for name, _ in
                              _moe_modules(model) for k in ("wi", "wo")])
    return model


def permute_expert_params(model, permutation):
    """Apply an expert permutation (e.g. from
    :func:`repro_torch.core.placement.place_experts`) to every MoE layer
    of ``model``, in place: ``wi`` (E, d, 2, F) and ``wo`` (E, F, d)
    reordered along E and the router's (d, E) columns to match, so
    routing is unchanged while expert *e* now lives at position
    ``permutation.index(e)``. Because the expert axis shards
    contiguously over ``model`` (:meth:`Partitioner.param_spec`), this
    reorder is the expert -> shard layout. Apply it to whole weights,
    before :func:`shard_experts`. Returns the model."""
    perm = torch.as_tensor(list(permutation), dtype=torch.long)
    with torch.no_grad():
        for _, m in _moe_modules(model):
            for k, axis in (("wi", 0), ("wo", 0), ("router", 1)):
                w = getattr(m, k)
                w.copy_(w.index_select(axis, perm.to(w.device)))
    return model
