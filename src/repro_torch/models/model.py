"""Model assembly of the dense, SSM and hybrid families: embedding ->
layers (and, for Zamba-2, the shared block at the head of each repeat
group) -> head.

The modules (:class:`Model`, :class:`Layer`, :class:`MambaLayer`,
:class:`SharedBlock`, :class:`LoRA`, :class:`Attention`, :class:`MLP`)
hold the reference's parameter layouts, one layer module per layer and
one :class:`LoRA` per repeat slot (the reference stacks repeat groups
and slots for ``lax.scan``; :mod:`repro_torch.models.convert` unstacks
them), so converting the JAX package's weights is a plain copy.

Modes: ``train`` (logits for every position), ``prefill`` (last-token
logits + a filled cache), ``decode`` (one token against the cache). The
cache is a list with one dict per entry of :func:`block_plan`, the
order the forward runs its blocks in: for the dense and SSM families one
per layer; for Zamba-2 one per layer plus one (a linear ``{"k", "v"}``)
per use of the shared block, before the layers of its group. Attention
layers hold ``{"k", "v"}`` (``dense_local`` layers as ring buffers of
length ``window``), Mamba layers ``{"conv_x", "conv_B", "conv_C",
"state"}``. Decode updates the cache tensors in place and hands the same
list back. Parameters are created with ``requires_grad=False``: the port
serves, and training (with the flash backward) comes later.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..configs.base import ModelConfig
from .blocks import (_init, check_supported, init_layer, init_shared_block,
                     init_shared_lora, layer_forward, shared_block_forward)
from .layers import embed_tokens, rms_norm, softcap

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ShardCtx:
    """Execution context threaded through the model. The port runs on
    one device, so it carries the mode only; a mesh raises until the
    sharding slice."""
    mesh: object = None
    mode: str = "train"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("sharded execution (a mesh) comes with "
                                      "the sharding slice of the port")

    def with_mode(self, mode: str) -> "ShardCtx":
        return ShardCtx(mode=mode)


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


class Layer(nn.Module):
    """One dense layer: norms ``ln1``/``ln2`` (and ``post_ln1``/
    ``post_ln2`` with post-block norms), ``attn`` and ``mlp``."""

    def __init__(self, kind: str, tensors: dict):
        super().__init__()
        self.kind = kind
        _params(self, tensors["norms"])
        self.attn = Attention(tensors["attn"])
        self.mlp = MLP(tensors["mlp"])

    def forward(self, x, *, cfg, mode, positions, cache=None):
        return layer_forward(self.kind, self, x, cfg=cfg, mode=mode,
                             positions=positions, cache=cache)


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

    def forward(self, x, *, cfg, mode, positions, cache=None):
        return layer_forward(self.kind, self, x, cfg=cfg, mode=mode,
                             positions=positions, cache=cache)


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
    """``embed`` (V, d), ``layers``, ``shared`` (a :class:`SharedBlock`,
    hybrid family only), ``final_norm`` (d,), and ``head`` (d, V) when
    the embeddings are not tied."""

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
        _params(self, {k: tensors[k] for k in ("embed", "final_norm", "head")
                       if k in tensors})

    def forward(self, batch: dict, ctx: "ShardCtx"):
        return forward(self, batch, self.cfg, ctx)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """Random weights at the reference's scales: every matrix N(0, 1) /
    sqrt(fan_in) (the embedding too: 1/sqrt(d) keeps tied-head logits
    O(1)), every norm scale zero; Mamba layers with A = -1 (``A_log``
    0), ``dt_bias`` 0 and ``D`` 1, and the shared block's LoRA ``b_*``
    zero, as in the reference. Draws from ``generator``, whose device
    must be ``device``."""
    check_supported(cfg)
    dt = DTYPES[cfg.dtype]
    device = torch.device(device) if device is not None \
        else generator.device
    d = cfg.d_model
    tensors = {"embed": _init(generator, (cfg.vocab, d), d, dt, device),
               "layers": [init_layer(kind, cfg, generator, dt, device)
                          for kind in cfg.layer_kinds()],
               "final_norm": torch.zeros((d,), dtype=dt, device=device)}
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

def _head(params: Model, x, cfg):
    x = rms_norm(x, params.final_norm)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params.embed)
    return torch.einsum("bsd,dv->bsv", x, params.head)


@torch.no_grad()
def forward(params: Model, batch: dict, cfg: ModelConfig, ctx: ShardCtx):
    """train -> (logits, aux); prefill -> (last_logits, aux, cache);
    decode -> (logits (B,V), aux, cache). ``batch["tokens"]`` (B, S)
    int64; decode adds ``batch["pos"]`` (an int: the absolute position
    of the token) and ``batch["cache"]`` (from :func:`init_cache` or a
    prefill, updated in place)."""
    mode = ctx.mode
    decode = mode == "decode"
    caches = batch["cache"] if decode else None
    x = embed_tokens(batch["tokens"], params.embed, cfg.embed_scale_by_dim)
    positions = int(batch["pos"]) if decode else \
        torch.arange(x.shape[1], device=x.device)
    emb0 = x if cfg.shared_attn_every else None

    aux = 0.0
    new_cache = []
    for j, (what, i) in enumerate(params.plan):
        c = caches[j] if decode else None
        if what == "shared":
            x, nc = shared_block_forward(
                params.shared, params.shared.lora[i], x, emb0, cfg=cfg,
                mode=mode, positions=positions, cache=c)
        else:
            x, a, nc = params.layers[i](x, cfg=cfg, mode=mode,
                                        positions=positions, cache=c)
            aux = aux + a
        new_cache.append(nc)
    aux = torch.tensor(aux, dtype=torch.float32)

    if mode == "train":
        return _head(params, x, cfg), aux
    if mode == "prefill":
        logits = _head(params, x[:, -1:], cfg)[:, 0]
        return softcap(logits, cfg.logit_softcap), aux, new_cache
    logits = _head(params, x, cfg)[:, 0]
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
    t = min(cfg.window, max_seq) if kind.endswith("local") else max_seq
    return {"k": zeros(b, t, cfg.n_kv_heads, cfg.head_dim),
            "v": zeros(b, t, cfg.n_kv_heads, cfg.head_dim)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device=None) -> list[dict]:
    """Zeros in ``cfg.dtype``, one dict per entry of :func:`block_plan`
    (the shared block's caches are linear, like a global layer's)."""
    dt = DTYPES[cfg.dtype]
    kinds = cfg.layer_kinds()
    return [_layer_cache(kinds[i] if what == "layer" else "dense_global",
                         cfg, batch_size, max_seq, dt, device)
            for what, i in block_plan(cfg)]
