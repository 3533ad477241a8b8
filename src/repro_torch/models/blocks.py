"""Per-layer blocks of the dense family: init + forward.

Kinds: ``dense_global`` / ``dense_local`` (attention + GLU MLP, optional
qk-norm / softcap / post-block norms). MLA (``kv_lora_rank``), MoE,
Mamba-2 and the Zamba-2 shared block are ported in later slices; asking
for one raises ``NotImplementedError``.

Init functions return dicts of tensors in the reference's layouts
(``wq`` (d, H, Dh), ``wo`` (H, Dh, d), ``wi`` (d, 2, F)); the modules of
:mod:`repro_torch.models.model` hold them as parameters, and the forward
functions here read them as attributes of those modules.

Every forward returns ``(x, aux_loss, new_cache)``; the cache is None
outside decode/prefill. KV caches of ``dense_local`` layers are ring
buffers of length ``window`` (RoPE is applied at insert with absolute
positions, so slot order is irrelevant to attention). Decode writes the
new token into the cache tensors in place and returns the same dict.
"""

from __future__ import annotations

import math

import torch

from .layers import (apply_rope, attention, attention_decode, glu_mlp,
                     rms_norm)

LATER_SLICES = {
    "mla": "MLA attention (kv_lora_rank > 0) is ported with the MLA slice",
    "moe": "MoE layers are ported with the MoE slice",
    "ssm": "Mamba-2 layers (and ssd_scan) are ported with the SSM slice",
    "hybrid": "the Zamba-2 shared block is ported with the SSM slice",
    "encoder": "frame frontends are ported with the frontends slice",
    "vlm": "patch frontends are ported with the frontends slice",
}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for anything outside the dense,
    token-frontend family this slice serves."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: "
            f"{LATER_SLICES.get(cfg.family, 'no slice planned')}")
    if cfg.kv_lora_rank:
        raise NotImplementedError(f"{cfg.name}: {LATER_SLICES['mla']}")
    if cfg.frontend != "token":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet "
            f"(patch/frame frontends come with the frontends slice)")


def _init(gen, shape, fan_in, dtype, device):
    """N(0, 1) / sqrt(fan_in), drawn in float32 and cast, as the
    reference's ``_init``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------

def init_attention(cfg, gen, dtype, device, d_in=None) -> dict:
    d = d_in or cfg.d_model
    p = {
        "wq": _init(gen, (d, cfg.n_heads, cfg.head_dim), d, dtype, device),
        "wk": _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), d, dtype, device),
        "wv": _init(gen, (d, cfg.n_kv_heads, cfg.head_dim), d, dtype, device),
        "wo": _init(gen, (cfg.n_heads, cfg.head_dim, d),
                    cfg.n_heads * cfg.head_dim, dtype, device),
    }
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
        p["knorm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    return p


def _qkv(p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    return q, k, v


def attn_forward(p, x, *, cfg, kind, mode, positions, cache=None):
    """Returns (attn_out (B,S,d), new_cache)."""
    local = kind.endswith("local")
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    window = cfg.window if local else None

    q, k, v = _qkv(p, x)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm)
        k = rms_norm(k, p.knorm)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    scale = cfg.attn_scale or (q.shape[-1] ** -0.5)

    if mode == "decode":
        # the slots < pos + 1 are valid, capped at T for a local ring:
        # the mask the reference's _cache_insert builds
        kc, vc = _cache_insert(cache, k, v, positions, window)
        out = attention_decode(q, kc, vc, pos=positions, scale=scale,
                               attn_softcap=cfg.attn_softcap,
                               ring=window is not None)
        new_cache = cache
    else:
        out = attention(q, k, v, causal=cfg.causal, window=window,
                        scale=scale, attn_softcap=cfg.attn_softcap)
        new_cache = _prefill_cache(k, v, window) if mode == "prefill" \
            else None
    out = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return out, new_cache


def _cache_insert(cache, k, v, positions, window):
    """Write one token at scalar absolute position ``positions`` into the
    (ring when local) cache, in place; return (k_cache, v_cache)."""
    kc, vc = cache["k"], cache["v"]
    t = kc.shape[1]
    pos = int(positions)
    slot = pos % t if window is not None else pos
    if not 0 <= slot < t:
        raise IndexError(f"decode position {pos} outside the linear cache "
                         f"of {t} slots")
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    return kc, vc


def _prefill_cache(k, v, window):
    if window is not None and k.shape[1] > window:
        # ring layout: position p lives at slot p % window
        s = k.shape[1]
        keep = torch.arange(s - window, s, device=k.device)
        slots = keep % window
        kc = torch.zeros((k.shape[0], window) + tuple(k.shape[2:]),
                         dtype=k.dtype, device=k.device)
        vc = torch.zeros_like(kc)
        kc[:, slots] = k[:, keep]
        vc[:, slots] = v[:, keep]
        return {"k": kc, "v": vc}
    return {"k": k.contiguous(), "v": v.contiguous()}


# ---------------------------------------------------------------------------
# dense transformer layers
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen, dtype, device, d_in=None) -> dict:
    d = d_in or cfg.d_model
    cols = 2 if cfg.activation in ("geglu", "swiglu") else 1
    return {"wi": _init(gen, (d, cols, cfg.d_ff), d, dtype, device),
            "wo": _init(gen, (cfg.d_ff, d), cfg.d_ff, dtype, device)}


def init_layer(kind, cfg, gen, dtype, device) -> dict:
    """{"norms": {...}, "attn": {...}, "mlp": {...}} for one dense layer
    (``kind`` is ``dense_global`` or ``dense_local``: the configs that
    :func:`check_supported` admits), all norm scales zero (identity
    under the zero-centred norm)."""
    d = cfg.d_model
    names = ["ln1", "ln2"] + (["post_ln1", "post_ln2"]
                              if cfg.post_block_norms else [])
    return {"norms": {n: torch.zeros((d,), dtype=dtype, device=device)
                      for n in names},
            "attn": init_attention(cfg, gen, dtype, device),
            "mlp": init_mlp(cfg, gen, dtype, device)}


def layer_forward(kind, p, x, *, cfg, mode, positions, cache=None):
    """One dense transformer layer ``p`` (a
    :class:`repro_torch.models.model.Layer`). Returns (x, aux,
    new_cache)."""
    h = rms_norm(x, p.ln1)
    attn_out, new_cache = attn_forward(p.attn, h, cfg=cfg, kind=kind,
                                       mode=mode, positions=positions,
                                       cache=cache)
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p.post_ln1)
    x = x + attn_out

    h = rms_norm(x, p.ln2)
    ff = glu_mlp(h, p.mlp.wi, p.mlp.wo, cfg.activation)
    if cfg.post_block_norms:
        ff = rms_norm(ff, p.post_ln2)
    return x + ff, 0.0, new_cache          # dense layers add no aux loss
