"""Per-layer blocks of the dense, MoE, SSM and hybrid families: init +
forward.

Kinds: ``dense_global`` / ``dense_local`` (attention + GLU MLP, optional
qk-norm / softcap / post-block norms), ``moe_global`` (attention + the
MoE FFN of :mod:`repro_torch.models.moe` + optional shared experts),
``ssm`` (Mamba-2), and the Zamba-2 shared transformer block (weights
reused across its slots, a LoRA of q/k/v per slot). Deepseek-style MLA
replaces the attention projections when ``cfg.kv_lora_rank > 0``: the
prefill materialises per-head K/V, decode runs the *absorbed* form
(scores in the latent space, so the cache stays (T, kv_lora + rope) per
token). The patch/frame frontends are ported in a later slice; asking
for one raises ``NotImplementedError``.

Init functions return dicts of tensors in the reference's layouts
(``wq`` (d, H, Dh), ``wo`` (H, Dh, d), ``wi`` (d, 2, F), ``wx`` (d,
d_inner), ``conv_x`` (K, d_inner), an expert ``wi`` (E, d, 2, F)); the
modules of :mod:`repro_torch.models.model` hold them as parameters, and
the forward functions here read them as attributes of those modules.

Every forward returns ``(x, aux_loss, new_cache)``; the cache is None
outside decode/prefill. KV caches of ``dense_local`` layers are ring
buffers of length ``window`` (RoPE is applied at insert with absolute
positions, so slot order is irrelevant to attention). An MLA layer's
cache holds the normed latent (B, T, kv_lora) and the roped shared key
``k_rope`` (B, T, rope). A Mamba layer's cache holds the last K-1
pre-activation conv inputs (``conv_x``, ``conv_B``, ``conv_C``) and the
(B, H, P, N) state. Decode writes the new token into the cache tensors
in place and returns the same dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import (NEG_INF, apply_rope, attention, attention_decode,
                     glu_mlp, rms_norm)
from .moe import moe_ffn
from .ssm import ssd_decode_step

LATER_SLICES = {
    "encoder": "frame frontends are ported with the frontends slice",
    "vlm": "patch frontends are ported with the frontends slice",
}
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for anything outside the families
    the port serves: dense and MoE (GQA or MLA attention), SSM (Mamba-2)
    and hybrid (Zamba-2), with the token frontend."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: "
            f"{LATER_SLICES.get(cfg.family, 'no slice planned')}")
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
    """GQA: ``wq`` (d, H, Dh), ``wk``/``wv`` (d, Hkv, Dh), ``wo`` (H, Dh,
    d). MLA (``kv_lora_rank`` L > 0): ``wq`` (d, H, nope + rope),
    ``wkv_a`` (d, L + rope), ``kv_norm`` (L,) zero, ``wkv_b`` (L, H,
    nope + v), ``wo`` (H, v, d). With qk-norm, ``qnorm``/``knorm`` of
    the q head width (nope + rope under MLA, whose forward, as the
    reference's, does not apply them)."""
    d = d_in or cfg.d_model
    h, lat = cfg.n_heads, cfg.kv_lora_rank
    if lat:
        dq = cfg.qk_nope_dim + cfg.qk_rope_dim
        p = {
            "wq": _init(gen, (d, h, dq), d, dtype, device),
            "wkv_a": _init(gen, (d, lat + cfg.qk_rope_dim), d, dtype, device),
            "kv_norm": torch.zeros((lat,), dtype=dtype, device=device),
            "wkv_b": _init(gen, (lat, h, cfg.qk_nope_dim + cfg.v_head_dim),
                           lat, dtype, device),
            "wo": _init(gen, (h, cfg.v_head_dim, d), h * cfg.v_head_dim,
                        dtype, device),
        }
    else:
        dq = cfg.head_dim
        p = {
            "wq": _init(gen, (d, h, dq), d, dtype, device),
            "wk": _init(gen, (d, cfg.n_kv_heads, dq), d, dtype, device),
            "wv": _init(gen, (d, cfg.n_kv_heads, dq), d, dtype, device),
            "wo": _init(gen, (h, dq, d), h * dq, dtype, device),
        }
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((dq,), dtype=dtype, device=device)
        p["knorm"] = torch.zeros((dq,), dtype=dtype, device=device)
    return p


def _qkv(p, x, lora=None):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if lora is not None:
        def ad(i, t, b):
            xa = torch.einsum("bsd,dr->bsr", x, lora.a[i])
            return t + torch.einsum("bsr,rhk->bshk", xa, b)
        q, k, v = ad(0, q, lora.b_q), ad(1, k, lora.b_k), ad(2, v, lora.b_v)
    return q, k, v


def attn_forward(p, x, *, cfg, kind, mode, positions, cache=None):
    """Returns (attn_out (B,S,d), new_cache)."""
    if cfg.kv_lora_rank:
        return _mla_forward(p, x, cfg=cfg, mode=mode, positions=positions,
                            cache=cache)
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
    pos = int(positions)  # lint: sync-ok decode passes the host's int
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
# MLA (deepseek): the prefill materialises per-head K/V; decode is absorbed
# ---------------------------------------------------------------------------

def _mla_forward(p, x, *, cfg, mode, positions, cache):
    """Multi-head latent attention. q = x·wq splits into (nope, rope)
    parts; x·wkv_a gives the latent (normed by ``kv_norm`` through the
    ``rmsnorm`` kernel) and one shared ``k_rope`` for all heads. RoPE
    turns ``q_rope`` and ``k_rope`` only. The scale is (nope + rope)^-0.5
    (``cfg.head_dim`` is 0 under MLA).

    Prefill (and train) materialise per-head K = [k_nope, k_rope] and V
    from latent·wkv_b and run the ``flash_attention`` kernel (head dims
    nope + rope for q/k, v for V); the prefill cache holds the normed
    latent and the roped ``k_rope``.

    Decode is absorbed: q_eff = q_nope·W_b^K is a (B, 1, H, L) query,
    attended with q_rope over [latent, k_rope] with the latent as V, then
    ·W_b^V. That is one kv head of 576 (q, k) and 512 (v) at deepseek's
    widths, above the 256 the ``flash_decode`` kernel takes, so this step
    runs in plain PyTorch with the reference's ``_decode_attn`` rounding
    (scores in the input type, softmax in float32, probabilities cast
    back before P·V) and launches no ``flash_decode``. An MLA decode
    kernel is a lead in ROADMAP.md; nothing is tried and given up here."""
    b, s, _ = x.shape
    h, lat = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dk->bsk", x, p.wkv_a)
    latent = rms_norm(kv_a[..., :lat], p.kv_norm)
    k_rope = apply_rope(kv_a[..., None, lat:], positions,
                        cfg.rope_theta)                       # (B,S,1,rope)
    scale = (nope + rope_d) ** -0.5

    if mode == "decode":
        wb_k, wb_v = p.wkv_b[..., :nope], p.wkv_b[..., nope:]
        q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wb_k)  # (B,1,H,L)
        lc, rc = _mla_cache_insert(cache, latent, k_rope[:, :, 0], positions)
        qcat = torch.cat([q_eff, q_rope], dim=-1)             # (B,1,H,L+r)
        kcat = torch.cat([lc, rc], dim=-1)                    # (B,T,L+r)
        scores = torch.einsum("bshc,btc->bhst", qcat, kcat) * scale
        valid = torch.arange(lc.shape[1], device=x.device) <= positions
        scores = scores.float().masked_fill(~valid, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out_l = torch.einsum("bhst,btl->bshl", probs, lc)      # (B,1,H,L)
        out = torch.einsum("bshl,lhv->bshv", out_l, wb_v)
        new_cache = cache
    else:
        kv = torch.einsum("bsl,lhk->bshk", latent, p.wkv_b)
        k = torch.cat([kv[..., :nope], k_rope.expand(b, s, h, rope_d)],
                      dim=-1)
        out = attention(torch.cat([q_nope, q_rope], dim=-1), k,
                        kv[..., nope:], causal=cfg.causal, scale=scale)
        new_cache = {"latent": latent, "k_rope": k_rope[:, :, 0]
                     .contiguous()} if mode == "prefill" else None
    return torch.einsum("bshv,hvd->bsd", out, p.wo), new_cache


def _mla_cache_insert(cache, latent, k_rope, positions):
    """Write one token's normed latent (B, 1, L) and roped ``k_rope``
    (B, 1, rope) at scalar absolute position ``positions`` of the linear
    cache, in place; return (latent cache, k_rope cache)."""
    lc, rc = cache["latent"], cache["k_rope"]
    t = lc.shape[1]
    pos = int(positions)  # lint: sync-ok decode passes the host's int
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} outside the linear cache "
                         f"of {t} slots")
    lc[:, pos] = latent[:, 0].to(lc.dtype)
    rc[:, pos] = k_rope[:, 0].to(rc.dtype)
    return lc, rc


# ---------------------------------------------------------------------------
# dense and MoE transformer layers
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen, dtype, device, d_in=None) -> dict:
    d = d_in or cfg.d_model
    cols = 2 if cfg.activation in ("geglu", "swiglu") else 1
    return {"wi": _init(gen, (d, cols, cfg.d_ff), d, dtype, device),
            "wo": _init(gen, (cfg.d_ff, d), cfg.d_ff, dtype, device)}


def init_layer(kind, cfg, gen, dtype, device) -> dict:
    """{"norms": {...}, "attn": {...}, "mlp": {...}} for one dense layer
    (``kind`` is ``dense_global`` or ``dense_local``); for a
    ``moe_global`` layer ``"moe"`` ({"router" (d, E) in float32 whatever
    the model's type, "wi" (E, d, 2, F), "wo" (E, F, d)}, F =
    ``d_ff_expert``) and, with shared experts, ``"shared_mlp"`` (a GLU
    MLP of width F · ``n_shared_experts``) in place of ``"mlp"``; the
    flat tensors of :func:`init_mamba` for an ``ssm`` layer. All norm
    scales zero (identity under the zero-centred norm)."""
    if kind == "ssm":
        return init_mamba(cfg, gen, dtype, device)
    d = cfg.d_model
    names = ["ln1", "ln2"] + (["post_ln1", "post_ln2"]
                              if cfg.post_block_norms else [])
    p = {"norms": {n: torch.zeros((d,), dtype=dtype, device=device)
                   for n in names},
         "attn": init_attention(cfg, gen, dtype, device)}
    if not kind.startswith("moe"):
        p["mlp"] = init_mlp(cfg, gen, dtype, device)
        return p
    e, f = cfg.n_experts, cfg.d_ff_expert
    p["moe"] = {"router": _init(gen, (d, e), d, torch.float32, device),
                "wi": _init(gen, (e, d, 2, f), d, dtype, device),
                "wo": _init(gen, (e, f, d), f, dtype, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_mlp"] = {"wi": _init(gen, (d, 2, fs), d, dtype, device),
                           "wo": _init(gen, (fs, d), fs, dtype, device)}
    return p


def layer_forward(kind, p, x, *, cfg, mode, positions, cache=None):
    """One layer ``p`` (a :class:`repro_torch.models.model.Layer`, or a
    :class:`~repro_torch.models.model.MambaLayer` for ``ssm``). Returns
    (x, aux, new_cache): ``aux`` is the router's load-balancing loss of
    a MoE layer, 0.0 for the others."""
    if kind == "ssm":
        y, new_cache = mamba_forward(p, x, cfg=cfg, mode=mode, cache=cache)
        return x + y, 0.0, new_cache
    h = rms_norm(x, p.ln1)
    attn_out, new_cache = attn_forward(p.attn, h, cfg=cfg, kind=kind,
                                       mode=mode, positions=positions,
                                       cache=cache)
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p.post_ln1)
    x = x + attn_out

    h = rms_norm(x, p.ln2)
    if kind.startswith("moe"):
        ff, aux = moe_ffn(h, p.moe, cfg)
        if cfg.n_shared_experts:
            ff = ff + glu_mlp(h, p.shared_mlp.wi, p.shared_mlp.wo,
                              cfg.activation)
    else:
        ff = glu_mlp(h, p.mlp.wi, p.mlp.wo, cfg.activation)
        aux = 0.0                          # dense layers add no aux loss
    if cfg.post_block_norms:
        ff = rms_norm(ff, p.post_ln2)
    return x + ff, aux, new_cache


# ---------------------------------------------------------------------------
# mamba2 layer
# ---------------------------------------------------------------------------

def init_mamba(cfg, gen, dtype, device) -> dict:
    """The reference's ``init_mamba``: matrices N(0, 1)/sqrt(fan_in),
    ``A_log`` and ``dt_bias`` zero (A = -1), ``D`` one, norm scales
    zero; ``A_log``, ``dt_bias`` and ``D`` in float32."""
    d, di = cfg.d_model, cfg.d_inner
    gn, h, k = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)
    return {
        "ln": zeros(d),
        "wz": _init(gen, (d, di), d, dtype, device),
        "wx": _init(gen, (d, di), d, dtype, device),
        "wB": _init(gen, (d, gn), d, dtype, device),
        "wC": _init(gen, (d, gn), d, dtype, device),
        "wdt": _init(gen, (d, h), d, dtype, device),
        "dt_bias": zeros(h, torch.float32),
        "conv_x": _init(gen, (k, di), k, dtype, device),
        "conv_B": _init(gen, (k, gn), k, dtype, device),
        "conv_C": _init(gen, (k, gn), k, dtype, device),
        "A_log": zeros(h, torch.float32),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "gate_norm": zeros(di),
        "wout": _init(gen, (di, d), di, dtype, device),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv. x (B,S,C); w (K,C); cache (B,K-1,C) for
    decode (S=1). Returns (y, new_cache or None). The prefill sums K
    shifted views, as the reference does (no ``F.conv1d``: cuDNN would
    run a float32 convolution in TF32)."""
    k = w.shape[0]
    if cache is not None:
        xin = torch.cat([cache, x], dim=1)                 # (B,K,C)
        y = torch.einsum("bkc,kc->bc", xin, w)[:, None]
        return y, xin[:, 1:]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = pad[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + pad[:, i:i + s] * w[i]
    return y, None


def mamba_forward(p, x, *, cfg, mode, cache=None):
    """Mamba-2 block ``p`` (a
    :class:`~repro_torch.models.model.MambaLayer`). The prefill runs the
    ``ssd_scan`` kernel through its guarded entry point (whatever
    ``cfg.attn_backend`` says), decode the one-token recurrence. Returns
    (y (B,S,d), new_cache)."""
    b, s, _ = x.shape
    g, n, h, pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_headdim
    hidden = rms_norm(x, p.ln)
    z = torch.einsum("bsd,de->bse", hidden, p.wz)
    xs = torch.einsum("bsd,de->bse", hidden, p.wx)
    Bs = torch.einsum("bsd,de->bse", hidden, p.wB)
    Cs = torch.einsum("bsd,de->bse", hidden, p.wC)
    dt = torch.einsum("bsd,dh->bsh", hidden, p.wdt)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    if mode == "decode":
        xs, cx = _causal_conv(xs, p.conv_x, cache["conv_x"])
        Bs, cB = _causal_conv(Bs, p.conv_B, cache["conv_B"])
        Cs, cC = _causal_conv(Cs, p.conv_C, cache["conv_C"])
        xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
        y1, state = ssd_decode_step(
            cache["state"], xs.reshape(b, h, pd), dt[:, 0], A,
            Bs.reshape(b, g, n), Cs.reshape(b, g, n))
        y = y1.reshape(b, 1, h, pd)
        xs_r = xs.reshape(b, 1, h, pd)
        for name, t in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC),
                        ("state", state)):
            cache[name].copy_(t)
        new_cache = cache
    else:
        xs, _ = _causal_conv(xs, p.conv_x)
        Bs, _ = _causal_conv(Bs, p.conv_B)
        Cs, _ = _causal_conv(Cs, p.conv_C)
        xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
        xs_r = xs.reshape(b, s, h, pd)
        y, state = ops.ssd_scan(xs_r.contiguous(), dt.contiguous(), A,
                                Bs.reshape(b, s, g, n).contiguous(),
                                Cs.reshape(b, s, g, n).contiguous(),
                                cfg.ssm_chunk)
        if mode == "prefill":
            k = cfg.ssm_conv
            # the conv tails need the *pre-activation* streams
            new_cache = {"conv_x": _conv_tail(hidden, p.wx, k),
                         "conv_B": _conv_tail(hidden, p.wB, k),
                         "conv_C": _conv_tail(hidden, p.wC, k),
                         "state": state}
        else:
            new_cache = None

    y = y + xs_r * p.D[:, None].to(y.dtype)
    y = y.reshape(b, -1, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p.gate_norm)
    return torch.einsum("bse,ed->bsd", y, p.wout), new_cache


def _conv_tail(hidden, w_proj, k):
    tail = hidden[:, -(k - 1):]
    out = torch.einsum("bsd,de->bse", tail, w_proj)
    pad = (k - 1) - tail.shape[1]
    if pad > 0:
        out = F.pad(out, (0, 0, pad, 0))
    return out


# ---------------------------------------------------------------------------
# zamba2 shared block (applied once per repeat group, per-slot LoRA)
# ---------------------------------------------------------------------------

def init_shared_block(cfg, gen, dtype, device) -> dict:
    """{"norms": {"ln1", "ln2"}, "attn", "mlp", "down"}: the shared
    transformer block on concat(x, emb0), 2 d wide, projected back to
    d by ``down`` (2d, d)."""
    d2 = 2 * cfg.d_model
    return {"norms": {n: torch.zeros((d2,), dtype=dtype, device=device)
                      for n in ("ln1", "ln2")},
            "attn": init_attention(cfg, gen, dtype, device, d_in=d2),
            "mlp": init_mlp(cfg, gen, dtype, device, d_in=d2),
            "down": _init(gen, (d2, cfg.d_model), d2, dtype, device)}


def init_shared_lora(cfg, gen, dtype, device) -> dict:
    """One slot's LoRA of the shared block's q/k/v: ``a`` (3, 2d, r)
    N(0, 1)/sqrt(2d), ``b_q``/``b_k``/``b_v`` (r, H, Dh) zero (so it adds
    nothing at init, as in the reference)."""
    d2, r = 2 * cfg.d_model, cfg.shared_lora_rank
    return {"a": _init(gen, (3, d2, r), d2, dtype, device),
            "b_q": torch.zeros((r, cfg.n_heads, cfg.head_dim), dtype=dtype,
                               device=device),
            "b_k": torch.zeros((r, cfg.n_kv_heads, cfg.head_dim),
                               dtype=dtype, device=device),
            "b_v": torch.zeros((r, cfg.n_kv_heads, cfg.head_dim),
                               dtype=dtype, device=device)}


def shared_block_forward(p, lora, x, emb0, *, cfg, mode, positions,
                         cache=None):
    """Zamba2: shared block ``p`` (a
    :class:`~repro_torch.models.model.SharedBlock`) on concat(x, emb0),
    with one slot's ``lora``, projected back to d and added to x. Its
    attention is causal, global, without softcap; the cache is a linear
    {"k", "v"}. Returns (x, new_cache)."""
    h0 = torch.cat([x, emb0], dim=-1)
    h = rms_norm(h0, p.ln1)
    q, k, v = _qkv(p.attn, h, lora)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = q.shape[-1] ** -0.5
    if mode == "decode":
        kc, vc = _cache_insert(cache, k, v, positions, None)
        out = attention_decode(q, kc, vc, pos=positions, scale=scale)
        new_cache = cache
    else:
        out = attention(q, k, v, causal=True, scale=scale)
        new_cache = {"k": k.contiguous(), "v": v.contiguous()} \
            if mode == "prefill" else None
    out = torch.einsum("bshk,hkd->bsd", out, p.attn.wo)
    h1 = h0 + out
    h2 = rms_norm(h1, p.ln2)
    h1 = h1 + glu_mlp(h2, p.mlp.wi, p.mlp.wo, cfg.activation)
    return x + torch.einsum("bse,ed->bsd", h1, p.down), new_cache
