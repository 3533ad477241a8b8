"""Model assembly of the dense family: embedding -> layers -> head.

The modules (:class:`Model`, :class:`Layer`, :class:`Attention`,
:class:`MLP`) hold the reference's parameter layouts, one
:class:`Layer` per layer (the reference stacks repeat groups for
``lax.scan``; :mod:`repro_torch.models.convert` unstacks them), so
converting the JAX package's weights is a plain copy.

Modes: ``train`` (logits for every position), ``prefill`` (last-token
logits + a filled cache), ``decode`` (one token against the cache).
``init_cache`` returns one ``{"k", "v"}`` per layer; ``dense_local``
layers use ring buffers of length ``window``. Decode updates the cache
tensors in place and hands the same list back. Parameters are created
with ``requires_grad=False``: this slice serves, and training (with the
flash backward) comes later.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..configs.base import ModelConfig
from .blocks import _init, check_supported, init_layer, layer_forward
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


class Model(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` (d,), and ``head``
    (d, V) when the embeddings are not tied."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kinds = cfg.layer_kinds()
        if len(tensors["layers"]) != len(kinds):
            raise ValueError(f"{cfg.name}: {len(tensors['layers'])} layers "
                             f"given, the config has {len(kinds)}")
        self.layers = nn.ModuleList(Layer(kind, t) for kind, t in
                                    zip(kinds, tensors["layers"]))
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
    O(1)), every norm scale zero. Draws from ``generator``, whose device
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

    aux = 0.0
    new_cache = []
    for i, layer in enumerate(params.layers):
        x, a, nc = layer(x, cfg=cfg, mode=mode, positions=positions,
                         cache=caches[i] if decode else None)
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
    t = min(cfg.window, max_seq) if kind.endswith("local") else max_seq
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device=None) -> list[dict]:
    dt = DTYPES[cfg.dtype]
    return [_layer_cache(kind, cfg, batch_size, max_seq, dt, device)
            for kind in cfg.layer_kinds()]
