"""Model assembly of every family: embedding or frontend -> layers (and,
for Zamba-2, the shared block at the head of each repeat group) -> head.

Frontends, as the reference's ``_embed``: ``token`` embeds
``batch["tokens"]``; ``patch_stub`` (the VLM) projects
``batch["patches"]`` (B, n_patches, d) by ``patch_proj`` and puts them
before the embedded tokens, with the prefix-LM mask over them
(``prefix_len = n_patches``; a decode step carries tokens only);
``frame_stub`` (the encoder) projects ``batch["frames"]`` (B, S, d) by
``frontend`` and has no token embedding.

The modules (:class:`Model`, :class:`Layer`, :class:`MambaLayer`,
:class:`SharedBlock`, :class:`LoRA`, :class:`Attention`, :class:`MLP`,
:class:`MoE`) hold the reference's parameter layouts, one layer module
per layer and one :class:`LoRA` per repeat slot (the reference stacks
repeat groups and slots for ``lax.scan``;
:mod:`repro_torch.models.convert` unstacks them), so converting the JAX
package's weights is a plain copy.

Modes: ``train`` (logits for every position), ``prefill`` (last-token
logits + a filled cache), ``decode`` (one token against the cache). The
cache is a list with one dict per entry of :func:`block_plan`, the
order the forward runs its blocks in: for the dense and SSM families one
per layer; for Zamba-2 one per layer plus one (a linear ``{"k", "v"}``)
per use of the shared block, before the layers of its group. Attention
layers hold ``{"k", "v"}`` (``dense_local`` layers as ring buffers of
length ``window``), MLA layers ``{"latent", "k_rope"}``, Mamba layers
``{"conv_x", "conv_B", "conv_C", "state"}``. Decode updates the cache
tensors in place and hands the same list back.

Parameters are created with ``requires_grad=False``, so a forward that
serves builds no autograd graph whatever the grad mode; the training
path (:mod:`repro_torch.runtime.train_loop`) turns them on. The forward
itself is differentiable: its kernels run inside autograd Functions
whose backward is a kernel too (:mod:`repro_torch.models.layers`), and
with ``cfg.remat`` ``"full"`` a training forward recomputes each layer
in the backward (``torch.utils.checkpoint``, as the reference
rematerialises its repeat groups); ``"dots"`` keeps the matrix products'
outputs and recomputes the rest.

Under FSDP (:func:`repro_torch.sharding.shard_params` or
``shard_experts`` with ``MeshAxes(fsdp=True)``) the model holds each
rank's slice over the data axes too, and ``fsdp_dims`` names them: the
forward gathers a layer's such weights over the data axes inside the
call that ``cfg.remat`` wraps, so under remat the gather runs again in
the backward's recomputation and no gathered weight is held from the
forward to the backward (FSDP's reshard after forward); the embedding,
frontends and head are gathered once a forward, outside the layers.
The blocks then see the tensor-parallel weights they read their layout
from.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from dataclasses import dataclass
from types import SimpleNamespace

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..configs.base import ModelConfig
from ..sharding.collectives import (assemble, fsdp_gather, psum,
                                    replicated_in)
from ..sharding.partition import cache_slices
from .blocks import (_init, check_supported, column_parallel, init_layer,
                     init_shared_block, init_shared_lora, layer_forward,
                     model_axis, shared_block_forward)
from .layers import embed_scale, embed_tokens, rms_norm, softcap

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOP_LEVEL = ("embed", "frontend", "patch_proj", "final_norm", "head")


ATTN_MODES = (None, "batch", "seq", "shard_map_seq")


@dataclass(frozen=True)
class ShardCtx:
    """Execution context threaded through the model: the mesh (None on
    one device), which axes shard the batch, the model / expert-parallel
    axis name, the mode, and ``attn_mode``, as the reference's.

    Under a mesh each rank runs the model on its data-parallel shard of
    the batch, whole over ``model_axis``: the residual stream is held
    alike by every rank of the axis. Each block reads its layout from
    the weights it holds (:func:`repro_torch.sharding.shard_params`
    keeps each rank's slice by :meth:`~repro_torch.sharding.Partitioner.
    param_spec`): attention heads, the MLP's F and the vocabulary split
    over ``model_axis`` run tensor-parallel
    (:mod:`repro_torch.models.blocks`), a MoE layer's experts split over
    it take the ``a2a`` dispatch, or in decode the ``local`` one
    (:func:`repro_torch.models.moe.moe_ffn`), and whole weights run as
    on one device. ``attn_mode`` says how small-head attention (heads
    that do not divide the axis, weights whole) claims the model axis:
    None (each rank computes it whole), ``"batch"`` (each rank takes a
    slice of the batch), ``"seq"`` or ``"shard_map_seq"`` (each rank
    takes a contiguous slice of the queries against every key, at its
    ``q_offset``); :func:`repro_torch.launch.specs.make_ctx` picks it.
    A parameter's gradient on a rank is its data-parallel shard's;
    averaging it over ``dp_axes`` is the train step's
    (:func:`repro_torch.runtime.train_loop.make_train_step`). ``mesh``
    may also be a mapping from axis name to size: such a context names
    a layout (the reference's ``AbstractMesh``) and executes nothing.
    ``vma_axes`` is JAX-only (the varying axes of a manual
    ``shard_map``): setting it raises ``NotImplementedError``."""
    mesh: object = None
    dp_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    mode: str = "train"
    attn_mode: str | None = None
    vma_axes: tuple[str, ...] = ()

    def __post_init__(self):
        if self.vma_axes:
            raise NotImplementedError(
                f"vma_axes={self.vma_axes!r}: the varying axes of a JAX "
                f"shard_map have no counterpart in the port")
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode {self.attn_mode!r} is not one of "
                             f"{ATTN_MODES}")
        if self.mesh is None:
            return
        if isinstance(self.mesh, Mapping):
            names = tuple(self.mesh)
        elif isinstance(self.mesh, DeviceMesh):
            names = self.mesh.mesh_dim_names
        else:
            raise TypeError(f"mesh: a DeviceMesh "
                            f"(repro_torch.launch.mesh.make_mesh) or a "
                            f"mapping of axis sizes, not "
                            f"{type(self.mesh).__name__}")
        missing = [a for a in (self.model_axis, *self.dp_axes)
                   if a not in names]
        if missing:
            raise ValueError(f"axes {missing} not in the mesh's {names}")

    def with_mode(self, mode: str) -> "ShardCtx":
        return dataclasses.replace(self, mode=mode)


def _params(module: nn.Module, tensors: dict) -> None:
    for name, t in tensors.items():
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


class Attention(nn.Module):
    """``wq`` (d, H, Dh), ``wk``/``wv`` (d, Hkv, Dh), ``wo`` (H, Dh, d),
    and ``qnorm``/``knorm`` (Dh,) when the config has qk-norm; read by
    :func:`repro_torch.models.blocks.attn_forward`."""

    def __init__(self, tensors: dict):
        super().__init__()
        _params(self, tensors)


class MLP(nn.Module):
    """``wi`` (d, 2, F) fused gate+up (d, 1, F without a GLU), ``wo``
    (F, d); read by :func:`repro_torch.models.blocks.layer_forward`."""

    def __init__(self, tensors: dict):
        super().__init__()
        _params(self, tensors)


class MoE(nn.Module):
    """A MoE layer's routed experts: ``router`` (d, E) float32, ``wi``
    (E, d, 2, F) fused gate+up, ``wo`` (E, F, d); read by
    :func:`repro_torch.models.moe.moe_ffn`."""

    def __init__(self, tensors: dict):
        super().__init__()
        _params(self, tensors)


class Layer(nn.Module):
    """One dense or MoE layer: norms ``ln1``/``ln2`` (and ``post_ln1``/
    ``post_ln2`` with post-block norms), ``attn`` (GQA or MLA), and
    ``mlp``, or for a ``moe_*`` kind ``moe`` and, with shared experts,
    ``shared_mlp``."""

    def __init__(self, kind: str, tensors: dict):
        super().__init__()
        self.kind = kind
        _params(self, tensors["norms"])
        self.attn = Attention(tensors["attn"])
        if kind.startswith("moe"):
            self.moe = MoE(tensors["moe"])
            if "shared_mlp" in tensors:
                self.shared_mlp = MLP(tensors["shared_mlp"])
        else:
            self.mlp = MLP(tensors["mlp"])

    def forward(self, x, *, cfg, mode, positions, cache=None,
                prefix_len=None, ctx=None):
        return layer_forward(self.kind, self, x, cfg=cfg, mode=mode,
                             positions=positions, cache=cache,
                             prefix_len=prefix_len, ctx=ctx)


class MambaLayer(nn.Module):
    """One Mamba-2 layer: ``ln`` (d,), ``wz``/``wx`` (d, d_inner),
    ``wB``/``wC`` (d, G·N), ``wdt`` (d, H), ``conv_x`` (K, d_inner),
    ``conv_B``/``conv_C`` (K, G·N), float32 ``dt_bias``/``A_log``/``D``
    (H,), ``gate_norm`` (d_inner,), ``wout`` (d_inner, d); read by
    :func:`repro_torch.models.blocks.mamba_forward`."""

    kind = "ssm"

    def __init__(self, tensors: dict):
        super().__init__()
        _params(self, tensors)

    def forward(self, x, *, cfg, mode, positions, cache=None,
                prefix_len=None, ctx=None):
        return layer_forward(self.kind, self, x, cfg=cfg, mode=mode,
                             positions=positions, cache=cache, ctx=ctx)


class LoRA(nn.Module):
    """One repeat slot's LoRA of the shared block's q/k/v: ``a`` (3, 2d,
    r) and ``b_q`` (r, H, Dh), ``b_k``/``b_v`` (r, Hkv, Dh)."""

    def __init__(self, tensors: dict):
        super().__init__()
        _params(self, tensors)


class SharedBlock(nn.Module):
    """Zamba-2's shared transformer block: norms ``ln1``/``ln2`` (2d,),
    ``attn`` and ``mlp`` on 2d-wide inputs, ``down`` (2d, d), and
    ``lora``, one :class:`LoRA` per repeat group; read by
    :func:`repro_torch.models.blocks.shared_block_forward`."""

    def __init__(self, tensors: dict, loras: list[dict]):
        super().__init__()
        _params(self, tensors["norms"])
        _params(self, {"down": tensors["down"]})
        self.attn = Attention(tensors["attn"])
        self.mlp = MLP(tensors["mlp"])
        self.lora = nn.ModuleList(LoRA(t) for t in loras)

    def forward(self, slot, x, emb0, *, cfg, mode, positions, cache=None,
                ctx=None):
        return shared_block_forward(self, self.lora[slot], x, emb0, cfg=cfg,
                                    mode=mode, positions=positions,
                                    cache=cache, ctx=ctx)


def block_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The blocks a forward runs, in order: ``("layer", i)`` for layer i,
    ``("shared", r)`` for the shared block with LoRA slot r, which heads
    repeat group r (Zamba-2; none before the tail layers)."""
    prologue, n_rep, unit, tail = cfg.repeat_structure()
    if not cfg.shared_attn_every:
        return [("layer", i) for i in range(cfg.n_layers)]
    plan = [("layer", i) for i in range(len(prologue))]
    for r in range(n_rep):
        first = len(prologue) + r * len(unit)
        plan += [("shared", r)] + [("layer", first + j)
                                   for j in range(len(unit))]
    first = len(prologue) + n_rep * len(unit)
    return plan + [("layer", first + j) for j in range(len(tail))]


class Model(nn.Module):
    """``embed`` (V, d) (absent under the frame frontend), ``frontend``
    (d, d) for ``frame_stub``, ``patch_proj`` (d, d) for ``patch_stub``,
    ``layers``, ``shared`` (a :class:`SharedBlock`, hybrid family only),
    ``final_norm`` (d,), and ``head`` (d, V) when the embeddings are not
    tied."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kinds = cfg.layer_kinds()
        if len(tensors["layers"]) != len(kinds):
            raise ValueError(f"{cfg.name}: {len(tensors['layers'])} layers "
                             f"given, the config has {len(kinds)}")
        self.layers = nn.ModuleList(
            MambaLayer(t) if kind == "ssm" else Layer(kind, t)
            for kind, t in zip(kinds, tensors["layers"]))
        if cfg.shared_attn_every:
            n_rep = cfg.repeat_structure()[1]
            if len(tensors["shared_lora"]) != n_rep:
                raise ValueError(f"{cfg.name}: {len(tensors['shared_lora'])}"
                                 f" LoRA slots given, the config has {n_rep}")
            self.shared = SharedBlock(tensors["shared"],
                                      tensors["shared_lora"])
        self.plan = block_plan(cfg)
        _params(self, {k: tensors[k] for k in TOP_LEVEL if k in tensors})

    def forward(self, batch: dict, ctx: "ShardCtx"):
        return forward(self, batch, self.cfg, ctx)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """Random weights at the reference's scales: every matrix N(0, 1) /
    sqrt(fan_in) (the embedding too: 1/sqrt(d) keeps tied-head logits
    O(1); the frontend projections likewise; a MoE router drawn in
    float32 and kept so), every norm scale
    zero; Mamba layers with A = -1 (``A_log`` 0), ``dt_bias`` 0 and
    ``D`` 1, and the shared block's LoRA ``b_*`` zero, as in the
    reference. Draws from ``generator``, whose device
    must be ``device``."""
    check_supported(cfg)
    dt = DTYPES[cfg.dtype]
    device = torch.device(device) if device is not None \
        else generator.device
    d = cfg.d_model
    if cfg.frontend == "frame_stub":
        tensors = {"frontend": _init(generator, (d, d), d, dt, device)}
    else:
        tensors = {"embed": _init(generator, (cfg.vocab, d), d, dt, device)}
        if cfg.frontend == "patch_stub":
            tensors["patch_proj"] = _init(generator, (d, d), d, dt, device)
    tensors.update(layers=[init_layer(kind, cfg, generator, dt, device)
                           for kind in cfg.layer_kinds()],
                   final_norm=torch.zeros((d,), dtype=dt, device=device))
    if cfg.shared_attn_every:
        n_rep = cfg.repeat_structure()[1]
        tensors["shared"] = init_shared_block(cfg, generator, dt, device)
        tensors["shared_lora"] = [init_shared_lora(cfg, generator, dt,
                                                   device)
                                  for _ in range(n_rep)]
    if not cfg.tie_embeddings:
        tensors["head"] = _init(generator, (d, cfg.vocab), d, dt, device)
    return Model(cfg, tensors)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _head(params: Model, x, cfg, ctx=None):
    """Logits (B, S, V). A head (or tied embedding) holding V / M of the
    vocabulary gives this rank's columns, assembled over the model axis:
    the loss is then the reference's ``cross_entropy`` on every rank
    (gathering the logits keeps that code and its softcap whole; a
    vocabulary-parallel log-sum-exp would save the (B, S, V) gather)."""
    x = rms_norm(x, params.final_norm)
    w = params.embed if cfg.tie_embeddings else params.head
    eq = "bsd,vd->bsv" if cfg.tie_embeddings else "bsd,dv->bsv"
    if w.shape[0 if cfg.tie_embeddings else 1] == cfg.vocab:
        return torch.einsum(eq, x, w)
    group, _, _ = model_axis(ctx, "head")
    return assemble(torch.einsum(eq, replicated_in(x, group), w), 2, group)


def _lookup(tokens, table, cfg, ctx):
    """The embedding rows of ``tokens``; a table holding V / M rows of
    the vocabulary (rank r rows r V / M ..) looks up the tokens it holds,
    zeros for the others, and a psum over the model axis joins them."""
    if table.shape[0] == cfg.vocab:
        return embed_tokens(tokens, table, cfg.embed_scale_by_dim)
    _, r, _ = model_axis(ctx, "embedding")
    vl = table.shape[0]
    local = tokens - r * vl
    mine = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    x = psum(torch.where(mine[..., None], rows, zero), ctx.mesh,
             (ctx.model_axis,))
    return embed_scale(x, table.shape[1]) if cfg.embed_scale_by_dim else x


def _embed(params: Model, batch: dict, cfg: ModelConfig, ctx=None):
    """(x (B, S, d), positions (S,), prefix_len (B,) int32 or None), as
    the reference's ``_embed``."""
    dt = DTYPES[cfg.dtype]
    if cfg.frontend == "frame_stub":
        x = column_parallel(batch["frames"].to(dt), params.frontend,
                            cfg.d_model, ctx, "frontend")
        return x, torch.arange(x.shape[1], device=x.device), None
    x = _lookup(batch["tokens"], params.embed, cfg, ctx)
    prefix_len = None
    if cfg.frontend == "patch_stub" and "patches" in batch:
        px = column_parallel(batch["patches"].to(dt), params.patch_proj,
                             cfg.d_model, ctx, "patch_proj")
        x = torch.cat([px, x], dim=1)
        prefix_len = torch.full((x.shape[0],), cfg.n_patches,
                                dtype=torch.int32, device=x.device)
    return x, torch.arange(x.shape[1], device=x.device), prefix_len


_DOT_OPS = frozenset(getattr(torch.ops.aten, name).default
                     for name in ("mm", "bmm", "addmm", "baddbmm"))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, mode: str):
    """How a block is called in this forward: directly, or (training with
    ``cfg.remat`` set and gradients on) through ``torch.utils.checkpoint``,
    which recomputes it in the backward; ``"dots"`` keeps the outputs of
    the matrix products (the reference's ``checkpoint_dots`` policy)."""
    if mode != "train" or cfg.remat == "none" or not torch.is_grad_enabled():
        return lambda fn: fn()
    from torch.utils import checkpoint as ckpt
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of "
                         f"full, dots, none")
    return lambda fn: ckpt.checkpoint(fn, use_reentrant=False, **kw)


def _fsdp_weights(params: Model, prefix: str, ctx) -> dict:
    """The parameters under ``prefix`` (``"layers.3."``; ``""`` for the
    top level alone) that ``params.fsdp_dims`` names, each gathered
    whole over its data axes: ``{name below prefix: tensor}``."""
    dims = getattr(params, "fsdp_dims", None)
    if not dims:
        return {}
    if ctx is None or not isinstance(ctx.mesh, DeviceMesh):
        raise ValueError("a model sharded over the data axes (FSDP) runs "
                         "under a ShardCtx on its DeviceMesh")
    return {name[len(prefix):]: fsdp_gather(params.get_parameter(name), dim,
                                            ctx.mesh, axes)
            for name, (dim, axes) in dims.items()
            if name.startswith(prefix) and (prefix or "." not in name)}


def _run_layer(params: Model, i: int, *args, **kwargs):
    """Layer ``i`` on ``args``, its FSDP weights gathered first: the body
    of a remat region."""
    layer = params.layers[i]
    weights = _fsdp_weights(params, f"layers.{i}.", kwargs.get("ctx"))
    if not weights:
        return layer(*args, **kwargs)
    return torch.func.functional_call(layer, weights, args, kwargs)


def _run_shared(params: Model, slot: int, *args, **kwargs):
    """The shared block with LoRA slot ``slot`` on ``args``, its FSDP
    weights (and that slot's) gathered first: the body of a remat
    region."""
    weights = {k: w for k, w in _fsdp_weights(params, "shared.",
                                              kwargs.get("ctx")).items()
               if not k.startswith("lora.") or
               k.startswith(f"lora.{slot}.")}
    if not weights:
        return params.shared(slot, *args, **kwargs)
    return torch.func.functional_call(params.shared, weights,
                                      (slot, *args), kwargs)


def forward(params: Model, batch: dict, cfg: ModelConfig, ctx: ShardCtx):
    """train -> (logits, aux); prefill -> (last_logits, aux, cache);
    decode -> (logits (B,V), aux, cache). ``aux`` is the float32 sum of
    the MoE layers' load-balancing losses (0 without MoE layers), on the
    device of the activations. ``batch["tokens"]`` (B, S) int64, with
    ``batch["patches"]`` (B, n_patches, d) for a VLM's prefill or
    training step, or ``batch["frames"]`` (B, S, d) for the encoder;
    decode adds ``batch["pos"]`` (an int: the absolute position of the
    token) and ``batch["cache"]`` (from :func:`init_cache` or a prefill,
    updated in place). Differentiable where the parameters require
    grad; the serving entry points run it under
    ``torch.inference_mode()``."""
    mode = ctx.mode
    decode = mode == "decode"
    caches = batch["cache"] if decode else None
    top = SimpleNamespace(**{k: getattr(params, k) for k in TOP_LEVEL
                             if hasattr(params, k)})
    vars(top).update(_fsdp_weights(params, "", ctx))
    x, positions, prefix_len = _embed(top, batch, cfg, ctx)
    if decode:
        positions = int(batch["pos"])
    emb0 = x if cfg.shared_attn_every else None
    call = _remat(cfg, mode)

    aux = 0.0
    new_cache = []
    for j, (what, i) in enumerate(params.plan):
        c = caches[j] if decode else None
        if what == "shared":
            x, nc = call(functools.partial(
                _run_shared, params, i, x, emb0, cfg=cfg, mode=mode,
                positions=positions, cache=c, ctx=ctx))
        else:
            x, a, nc = call(functools.partial(
                _run_layer, params, i, x, cfg=cfg, mode=mode,
                positions=positions, cache=c, prefix_len=prefix_len,
                ctx=ctx))
            aux = aux + a
        new_cache.append(nc)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)

    if mode == "train":
        return _head(top, x, cfg, ctx), aux
    if mode == "prefill":
        logits = _head(top, x[:, -1:], cfg, ctx)[:, 0]
        return softcap(logits, cfg.logit_softcap), aux, new_cache
    logits = _head(top, x, cfg, ctx)[:, 0]
    return softcap(logits, cfg.logit_softcap), aux, new_cache


# ---------------------------------------------------------------------------
# cache init (zeros — for serving)
# ---------------------------------------------------------------------------

def _layer_cache(kind, cfg, b, max_seq, dt, device):
    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)
    if kind == "ssm":
        k, gn = cfg.ssm_conv - 1, cfg.ssm_ngroups * cfg.ssm_state
        return {"conv_x": zeros(b, k, cfg.d_inner),
                "conv_B": zeros(b, k, gn), "conv_C": zeros(b, k, gn),
                "state": zeros(b, cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state)}
    if cfg.kv_lora_rank:
        return {"latent": zeros(b, max_seq, cfg.kv_lora_rank),
                "k_rope": zeros(b, max_seq, cfg.qk_rope_dim)}
    t = min(cfg.window, max_seq) if kind.endswith("local") else max_seq
    return {"k": zeros(b, t, cfg.n_kv_heads, cfg.head_dim),
            "v": zeros(b, t, cfg.n_kv_heads, cfg.head_dim)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device=None, part=None) -> list[dict]:
    """Zeros in ``cfg.dtype``, one dict per entry of :func:`block_plan`
    (the shared block's caches are linear, like a global layer's). With
    ``part`` (the :class:`~repro_torch.sharding.Partitioner` a model was
    kept by, ``model.partitioner``), this rank's slice of each tensor at
    its :meth:`~repro_torch.sharding.Partitioner.cache_spec`
    (:func:`repro_torch.sharding.cache_slices`)."""
    dt = DTYPES[cfg.dtype]
    kinds = cfg.layer_kinds()
    caches = [_layer_cache(kinds[i] if what == "layer" else "dense_global",
                           cfg, batch_size, max_seq, dt,
                           device if part is None else "meta")
              for what, i in block_plan(cfg)]
    if part is None:
        return caches
    return [{k: torch.zeros([s.stop - s.start for s in
                             cache_slices(part, k, tuple(t.shape))],
                            dtype=dt, device=device) for k, t in c.items()}
            for c in caches]
