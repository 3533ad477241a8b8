"""Per-layer blocks of every family (dense, MoE, SSM, hybrid, the
encoder and the VLM): init + forward.

Kinds: ``dense_global`` / ``dense_local`` (attention + GLU MLP, optional
qk-norm / softcap / post-block norms), ``moe_global`` (attention + the
MoE FFN of :mod:`repro_torch.models.moe` + optional shared experts),
``ssm`` (Mamba-2), and the Zamba-2 shared transformer block (weights
reused across its slots, a LoRA of q/k/v per slot). Deepseek-style MLA
replaces the attention projections when ``cfg.kv_lora_rank > 0``: the
prefill materialises per-head K/V, decode runs the *absorbed* form
(scores in the latent space, so the cache stays (T, kv_lora + rope) per
token). The encoder (hubert) and the VLM (paligemma) run the dense
layers: the encoder's attention is bidirectional (``cfg.causal``
False), the VLM's takes the prefix-LM mask over its image patches
(``prefix_len``); their frontends live in
:mod:`repro_torch.models.model`.

Tensor parallelism (a mesh's ``model`` axis of M ranks, weights kept by
:func:`repro_torch.sharding.shard_params`): each block reads its layout
from the weights it holds, against the config's counts, so one model
runs whole, experts-only (MoE) or tensor-parallel alike, in every
family. The residual
stream is held whole by every rank of the axis, and its gradient, after
the backward, is the whole gradient on every rank (the convention of
:mod:`repro_torch.sharding.collectives`). Attention whose heads divide M
holds ``H / M`` q heads (and ``Hkv / M`` kv heads, or all of them when
those do not divide: each rank then takes the kv heads of its own q
heads); its input enters by ``replicated_in`` (the ranks' partial input
gradients summed), ``wo`` is row-parallel and the output a ``psum``.
Attention whose heads do not divide M keeps its weights whole and claims
the axis by the context's ``attn_mode``: ``"seq"``/``"shard_map_seq"``
(each rank a contiguous slice of the queries against every key, at
``q_offset`` = rank x S / M, the output assembled over the sequence) or
``"batch"`` (a slice of the batch); None computes it whole on every
rank. The MLP holds F / M columns of ``wi`` and rows of ``wo``, then a
``psum`` (a MoE layer's shared experts alike; its routed experts by
:func:`repro_torch.models.moe.moe_ffn`). MLA holds H / M heads of
``wq``, ``wkv_b`` and ``wo``; its latent projection and norm are whole.
A Mamba-2 layer holds H / M of its scan's heads: ``wz``/``wx``/``wdt``
column-parallel, ``dt_bias``/``A_log``/``D`` and ``conv_x``'s channels
over heads, ``wB``/``wC``/``conv_B``/``conv_C`` whole (each rank reads
the groups of its heads), the gated norm over all of ``d_inner`` by a
psum of its sum of squares, ``wout`` row-parallel and a psum. Zamba-2's
shared block splits its heads (the LoRA's ``b_*`` with them, ``a``
whole) and its MLP, and ``down`` is column-parallel, assembled. A
replicated weight whose use is split over the ranks (the selected
``wk``/``wv``, ``qnorm``/``knorm`` over split heads, every attention
weight under ``"seq"``/``"batch"``, Mamba's ``wB``/``wC``/``conv_B``/
``conv_C``, the LoRA ``a``, MLA's ``wkv_a``/``kv_norm``) enters by
``replicated_in``, so its gradient is summed over the axis; a norm scale
on the replicated residual is not.

Decode under tensor parallelism reads caches at
:meth:`repro_torch.sharding.Partitioner.cache_spec`'s layout (an
attention module that :func:`~repro_torch.sharding.shard_params` kept is
marked ``caches_by_spec``): where the kv heads divide M each rank holds
its kv heads over every slot, runs ``flash_decode`` on them and a
``psum`` after ``wo``; otherwise (and MLA's latent always) each rank
holds slots ``[r T / M, (r + 1) T / M)`` of every kv head. The rank that
owns the new token's slot writes it, every rank attends the whole query
(assembled over heads where they are split) over its own slots, with the
log-sum-exp beside each partial, and the partials are merged in rank
order in float32 (:func:`repro_torch.kernels.flash_decode.merge_ranges`);
each rank then keeps its own heads for a row-parallel ``wo``. A Mamba
layer's state and ``conv_x`` tail are over heads, ``conv_B``/``conv_C``
whole.

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
from types import SimpleNamespace

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.flash_decode import merge_ranges
from ..launch.mesh import axis_sizes, mesh_coords
from ..sharding.collectives import assemble, psum, replicated_in, slice_in
from ..spans import span
from .layers import (NEG_INF, apply_rope, attention, attention_decode,
                     glu_mlp, rms_norm, ssd_scan)
from .moe import moe_ffn
from .ssm import ssd_decode_step

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")
FRONTENDS = ("token", "patch_stub", "frame_stub")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a family or frontend the model does not
    know (every family of the configs is ported)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")


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


def _proj(x, w, lora=None, i=0):
    """x · w (d, H, Dh) per head, plus a slot's LoRA ``(x · a[i]) · b_*``
    of q (i 0), k (1) or v (2) where ``lora`` is given."""
    y = torch.einsum("bsd,dhk->bshk", x, w)
    if lora is None:
        return y
    xa = torch.einsum("bsd,dr->bsr", x, lora.a[i])
    b = (lora.b_q, lora.b_k, lora.b_v)[i]
    return y + torch.einsum("bsr,rhk->bshk", xa, b)


def model_axis(ctx, what: str):
    """(group, index, size) of the context's model axis, for a block
    whose weights are this rank's slice; raises without a mesh to run
    on."""
    if ctx is None or not isinstance(ctx.mesh, DeviceMesh):
        raise ValueError(f"{what}: the weights are this rank's slice; run "
                         f"under a ShardCtx of the DeviceMesh they were "
                         f"sharded over")
    axis = ctx.model_axis
    return (ctx.mesh.get_group(axis), mesh_coords(ctx.mesh)[axis],
            axis_sizes(ctx.mesh)[axis])


def column_parallel(x, w, d_out, ctx, what):
    """x · w, where ``w`` may hold this rank's columns of a (d, d_out)
    projection: then x enters by ``replicated_in`` and the columns are
    assembled over the model axis."""
    if w.shape[1] == d_out:
        return torch.einsum("bsd,de->bse", x, w)
    group = model_axis(ctx, what)[0]
    return assemble(torch.einsum("bsd,de->bse", replicated_in(x, group), w),
                    2, group)


def _ffn(p, h, cfg, width, ctx, what="MLP"):
    """The GLU MLP ``p`` (``wi``, ``wo``) of F = ``width``; one holding
    this rank's F columns runs on ``h`` by ``replicated_in`` and a psum
    joins the ranks' rows of ``wo``."""
    if p.wi.shape[-1] == width:
        return glu_mlp(h, p.wi, p.wo, cfg.activation)
    group, _, _ = model_axis(ctx, what)
    return psum(glu_mlp(replicated_in(h, group), p.wi, p.wo, cfg.activation),
                ctx.mesh, (ctx.model_axis,))


def seq_split_cache(p, cfg, ctx) -> bool:
    """Whether attention ``p`` decodes against a cache cut over its slots
    (:meth:`~repro_torch.sharding.Partitioner.cache_spec`'s layout where
    the kv heads do not divide the model axis; MLA's latent always): an
    attention module kept by ``shard_params`` (``caches_by_spec``) under
    a mesh."""
    if not getattr(p, "caches_by_spec", False) or ctx is None \
            or not isinstance(ctx.mesh, DeviceMesh):
        return False
    m = axis_sizes(ctx.mesh)[ctx.model_axis]
    return bool(cfg.kv_lora_rank) or cfg.n_kv_heads % m != 0


def _own_slot(t_loc: int, pos: int, ctx, ring: bool):
    """For a cache cut over its T slots (``t_loc`` of them on this
    rank) and the new token's absolute position ``pos``: (group, rank,
    the token's local slot if this rank owns it else None, this rank's
    count of valid slots)."""
    group, r, m = model_axis(ctx, "decode over a cache split along T")
    t = t_loc * m
    slot = pos % t if ring else pos
    if not 0 <= slot < t:
        raise IndexError(f"decode position {pos} outside the linear cache "
                         f"of {t} slots")
    limit = min(pos + 1, t) if ring else pos + 1
    mine = slot - r * t_loc if slot // t_loc == r else None
    return group, r, mine, min(max(limit - r * t_loc, 0), t_loc)


def _merge_over(out, lse, group):
    """The ranks' partials of one attention (``out`` (B, H, D), ``lse``
    (B, H), each over its own slots) merged in rank order in float32, on
    every rank: :func:`repro_torch.kernels.flash_decode.merge_ranges`."""
    n = dist.get_world_size(group)
    outs = [torch.empty_like(out) for _ in range(n)]
    lses = [torch.empty_like(lse) for _ in range(n)]
    dist.all_gather(outs, out.contiguous(), group=group)
    dist.all_gather(lses, lse.contiguous(), group=group)
    return merge_ranges(outs, lses)[0]


def _kv_heads(h0: int, hl: int, g: int) -> list[int]:
    """The kv heads q heads ``h0 .. h0 + hl - 1`` attend (head h the kv
    head h // g): each once where every one serves as many of them, in
    order, else one per q head."""
    idx = [h // g for h in range(h0, h0 + hl)]
    uniq = sorted(set(idx))
    per = hl // len(uniq)
    return uniq if idx == [u for u in uniq for _ in range(per)] else idx


def _rope_window(cfg, kind):
    local = kind.endswith("local")
    return (cfg.rope_theta_local if local else cfg.rope_theta,
            cfg.window if local else None)


def _q(w, x, cfg, theta, positions, lora=None):
    """The roped queries of ``x`` by ``w.wq`` (qk-normed)."""
    q = _proj(x, w.wq, lora, 0)
    if cfg.qk_norm:
        q = rms_norm(q, w.qnorm)
    return apply_rope(q, positions, theta)


def _kv(w, x, cfg, theta, positions, lora=None):
    """The roped keys (qk-normed) and the values of ``x``."""
    k = _proj(x, w.wk, lora, 1)
    v = _proj(x, w.wv, lora, 2)
    if cfg.qk_norm:
        k = rms_norm(k, w.knorm)
    return apply_rope(k, positions, theta), v


def _attn_body(w, xq, xkv, *, cfg, kind, mode, positions, q_pos=None,
               q_offset=0, cache=None, prefix_len=None, kv_group=None,
               lora=None):
    """The attention math on prepared inputs, the one body of every
    layout: q from ``xq``, k/v from ``xkv``, with ``w``'s ``wq``/``wk``/
    ``wv``/``wo`` (and ``qnorm``/``knorm`` under qk-norm; a slot's LoRA
    of q/k/v where ``lora`` is given). ``q_pos`` (default ``positions``)
    are the queries' RoPE positions and ``q_offset`` the first one's
    place among the keys; under ``kv_group`` the roped k/v enter by
    ``replicated_in`` (every rank's queries see every key, so their
    gradients are summed). Returns (out (B, Sq, d) before any
    collective, new_cache)."""
    theta, window = _rope_window(cfg, kind)
    scale = cfg.attn_scale or (w.wq.shape[-1] ** -0.5)
    q = _q(w, xq, cfg, theta, positions if q_pos is None else q_pos, lora)
    k, v = _kv(w, xkv, cfg, theta, positions, lora)

    if mode == "decode":
        # the slots < pos + 1 are valid, capped at T for a local ring:
        # the mask the reference's _cache_insert builds
        kc, vc = _cache_insert(cache, k, v, positions, window)
        out = attention_decode(q, kc, vc, pos=positions, scale=scale,
                               attn_softcap=cfg.attn_softcap,
                               ring=window is not None)
        new_cache = cache
    else:
        if kv_group is not None:
            k, v = replicated_in(k, kv_group), replicated_in(v, kv_group)
        out = attention(q, k, v, causal=cfg.causal, window=window,
                        scale=scale, attn_softcap=cfg.attn_softcap,
                        prefix_len=prefix_len, q_offset=q_offset)
        new_cache = _prefill_cache(k, v, window) if mode == "prefill" \
            else None
    return torch.einsum("bshk,hkd->bsd", out, w.wo), new_cache


def _attn_tp(p, x, *, cfg, ctx, lora=None, **kw):
    """Attention of this rank's q heads (``p.wq`` holds H / M of them):
    q/k/v column-parallel, ``wo`` row-parallel, a psum. Where the kv
    heads are whole each rank takes those of its q heads; its prefill
    cache then holds every kv head, whole over the prompt, for
    :func:`repro_torch.runtime.pad_cache_to` to cut over the slots."""
    group, r, _ = model_axis(ctx, "attention heads")
    hl = p.wq.shape[1]
    wk, wv = p.wk, p.wv
    b_kv = () if lora is None else (lora.b_k, lora.b_v)
    whole_kv = wk.shape[1] == cfg.n_kv_heads
    if whole_kv:                            # kv heads whole: pick ours
        sel = _kv_heads(r * hl, hl, cfg.n_heads // cfg.n_kv_heads)
        wk, wv, *b_kv = (replicated_in(t, group)[:, sel]
                         for t in (wk, wv, *b_kv))
    lk = None if lora is None else SimpleNamespace(
        a=replicated_in(lora.a, group), b_q=lora.b_q, b_k=b_kv[0],
        b_v=b_kv[1])
    w = SimpleNamespace(wq=p.wq, wk=wk, wv=wv, wo=p.wo)
    if cfg.qk_norm:
        w.qnorm = replicated_in(p.qnorm, group)
        w.knorm = replicated_in(p.knorm, group)
    x = replicated_in(x, group)
    out, new_cache = _attn_body(w, x, x, cfg=cfg, lora=lk, **kw)
    if new_cache is not None and whole_kv:  # every kv head, for T-split
        theta, window = _rope_window(cfg, kw["kind"])
        new_cache = _prefill_cache(*_kv(p, x, cfg, theta, kw["positions"],
                                        lora), window)
    return psum(out, ctx.mesh, (ctx.model_axis,)), new_cache


def _attn_decode_seq(p, x, *, cfg, ctx, kind, positions, cache, lora=None,
                     **_):
    """Decode against a K/V cache cut over its slots (each rank slots
    ``[r T / M, (r + 1) T / M)`` of every kv head; the kv weights are
    whole): the owner of the new token's slot writes it (``pos``, or
    ``pos % T`` in a ring), the query is assembled over heads where
    they are split, every rank runs ``flash_decode`` with the
    log-sum-exp over its own valid slots (none: a local ``pos`` of -1),
    the partials are merged in rank order, and each rank keeps its own
    heads for the row-parallel ``wo`` and its psum (all of them, and a
    whole ``wo``, where the heads are whole)."""
    theta, window = _rope_window(cfg, kind)
    scale = cfg.attn_scale or (p.wq.shape[-1] ** -0.5)
    kc, vc = cache["k"], cache["v"]
    pos = int(positions)  # lint: sync-ok decode passes the host's int
    group, r, mine, count = _own_slot(kc.shape[1], pos, ctx,
                                      window is not None)
    q = _q(p, x, cfg, theta, positions, lora)
    if mine is not None:
        k, v = _kv(p, x, cfg, theta, positions, lora)
        kc[:, mine] = k[:, 0].to(kc.dtype)
        vc[:, mine] = v[:, 0].to(vc.dtype)
    hl = q.shape[2]
    split = hl != cfg.n_heads
    if split:
        q = assemble(q, 2, group)
    out, lse = attention_decode(q, kc, vc, pos=count - 1, scale=scale,
                                attn_softcap=cfg.attn_softcap,
                                return_lse=True)
    out = _merge_over(out[:, 0], lse, group).to(x.dtype)[:, None]
    if not split:
        return torch.einsum("bshk,hkd->bsd", out, p.wo), cache
    out = out[:, :, r * hl:(r + 1) * hl]
    return psum(torch.einsum("bshk,hkd->bsd", out, p.wo), ctx.mesh,
                (ctx.model_axis,)), cache


def _attn_claimed(p, x, *, cfg, ctx, positions, prefix_len, **kw):
    """Small-head attention (weights whole) over the model axis by
    ``ctx.attn_mode``: ``"batch"`` gives each rank B / M rows of the
    batch; ``"seq"``/``"shard_map_seq"`` gives it S / M contiguous query
    rows at ``q_offset`` = rank x S / M against every key, the reference's
    ``_shard_map_seq_attention``. The output is assembled, whole on
    every rank of the axis (the reference hands the residual back in its
    dp-only layout)."""
    group, r, m = model_axis(ctx, f"attn_mode {ctx.attn_mode!r}")
    by_batch = ctx.attn_mode == "batch"
    dim = 0 if by_batch else 1
    if x.shape[dim] % m:
        raise ValueError(f"attn_mode {ctx.attn_mode!r}: dim {dim} of "
                         f"{tuple(x.shape)} does not split over {m} ranks")
    w = SimpleNamespace(wq=replicated_in(p.wq, group),
                        wo=replicated_in(p.wo, group), wk=p.wk, wv=p.wv)
    if cfg.qk_norm:
        w.qnorm, w.knorm = replicated_in(p.qnorm, group), p.knorm
    lora = kw.pop("lora", None)
    if lora is not None:          # a and b_q as wq; b_k/b_v as wk/wv
        lora = SimpleNamespace(a=replicated_in(lora.a, group),
                               b_q=replicated_in(lora.b_q, group),
                               b_k=lora.b_k, b_v=lora.b_v)
    kw["lora"] = lora
    x_loc = slice_in(x, dim, group)
    if by_batch:
        w.wk, w.wv = replicated_in(p.wk, group), replicated_in(p.wv, group)
        if lora is not None:
            lora.b_k = replicated_in(lora.b_k, group)
            lora.b_v = replicated_in(lora.b_v, group)
        if cfg.qk_norm:
            w.knorm = replicated_in(p.knorm, group)
        if prefix_len is not None:
            n = prefix_len.shape[0] // m
            prefix_len = prefix_len[r * n:(r + 1) * n]
        out, new_cache = _attn_body(w, x_loc, x_loc, cfg=cfg,
                                    positions=positions,
                                    prefix_len=prefix_len, **kw)
        if new_cache is not None:
            new_cache = {n: assemble(t, 0, group)
                         for n, t in new_cache.items()}
    else:
        n = x.shape[1] // m
        out, new_cache = _attn_body(
            w, x_loc, x, cfg=cfg, positions=positions,
            q_pos=positions[r * n:(r + 1) * n], q_offset=r * n,
            prefix_len=prefix_len, kv_group=group, **kw)
    return assemble(out, dim, group), new_cache


def attn_forward(p, x, *, cfg, kind, mode, positions, cache=None,
                 prefix_len=None, ctx=None, lora=None):
    """Returns (attn_out (B,S,d), new_cache). ``prefix_len`` (B,): the
    prefix-LM boundary of the prefill (a VLM's image patches); ``lora``:
    a slot's LoRA of q/k/v (Zamba-2's shared block). Under a mesh
    (``ctx``), the tensor-parallel heads where ``p.wq`` holds fewer than
    the config's, else the context's ``attn_mode`` outside decode; in
    decode a cache cut over its slots where :func:`seq_split_cache` says
    so (see the module's notes). Every other layout runs
    :func:`_attn_body`."""
    with span("model.attention"):
        if cfg.kv_lora_rank:
            return _mla_forward(p, x, cfg=cfg, mode=mode, positions=positions,
                                cache=cache, ctx=ctx)
        kw = dict(cfg=cfg, kind=kind, mode=mode, positions=positions,
                  prefix_len=prefix_len, lora=lora)
        if mode == "decode" and seq_split_cache(p, cfg, ctx):
            return _attn_decode_seq(p, x, ctx=ctx, cache=cache, **kw)
        split = p.wq.shape[1] != cfg.n_heads
        claim = ctx.attn_mode if ctx is not None and ctx.mesh is not None \
            and mode != "decode" else None
        if not (split or claim):
            return _attn_body(p, x, x, cache=cache, **kw)
        if split and claim:
            raise ValueError(f"attn_mode {claim!r} is for heads that do not "
                             f"divide the model axis; these are split "
                             f"({p.wq.shape[1]} of {cfg.n_heads} here)")
        return (_attn_tp if split else _attn_claimed)(p, x, ctx=ctx,
                                                      cache=cache, **kw)


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

def _mla_forward(p, x, *, cfg, mode, positions, cache, ctx=None):
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
    kernel is a lead in ROADMAP.md; nothing is tried and given up here.

    Under tensor parallelism ``wq``, ``wkv_b`` and ``wo`` hold H / M
    heads (the latent projection ``wkv_a`` and ``kv_norm`` whole, by
    ``replicated_in``), ``wo`` is row-parallel and a psum follows. A
    model kept by ``shard_params`` decodes against a latent cut over its
    slots (:func:`_mla_decode_seq`); its prefill cache is whole over the
    prompt, cut by :func:`repro_torch.runtime.pad_cache_to`."""
    b, s, _ = x.shape
    hl, lat = p.wq.shape[1], cfg.kv_lora_rank
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    split = hl != cfg.n_heads
    wkv_a, kv_norm = p.wkv_a, p.kv_norm
    if split:
        group, _, _ = model_axis(ctx, "MLA heads")
        x = replicated_in(x, group)
        wkv_a, kv_norm = replicated_in(wkv_a, group), \
            replicated_in(kv_norm, group)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dk->bsk", x, wkv_a)
    latent = rms_norm(kv_a[..., :lat], kv_norm)
    k_rope = apply_rope(kv_a[..., None, lat:], positions,
                        cfg.rope_theta)                       # (B,S,1,rope)
    scale = (nope + rope_d) ** -0.5

    if mode == "decode" and seq_split_cache(p, cfg, ctx):
        out, new_cache = _mla_decode_seq(p, x, q_nope, q_rope, latent,
                                         k_rope, cfg=cfg, ctx=ctx,
                                         positions=positions, cache=cache,
                                         scale=scale)
    elif mode == "decode":
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
        k = torch.cat([kv[..., :nope], k_rope.expand(b, s, hl, rope_d)],
                      dim=-1)
        out = attention(torch.cat([q_nope, q_rope], dim=-1), k,
                        kv[..., nope:], causal=cfg.causal, scale=scale)
        new_cache = {"latent": latent, "k_rope": k_rope[:, :, 0]
                     .contiguous()} if mode == "prefill" else None
    y = torch.einsum("bshv,hvd->bsd", out, p.wo)
    if split:
        y = psum(y, ctx.mesh, (ctx.model_axis,))
    return y, new_cache


def _mla_decode_seq(p, x, q_nope, q_rope, latent, k_rope, *, cfg, ctx,
                    positions, cache, scale):
    """The absorbed decode against a latent cache cut over its slots
    (each rank slots ``[r T / M, (r + 1) T / M)`` of ``latent`` and
    ``k_rope``): the owner of slot ``pos`` writes the token, q_eff (this
    rank's heads) and q_rope are assembled over heads where they are
    split, each rank's softmax over its own valid slots gives its
    partial of P·latent with the log-sum-exp (the one-device step's
    rounding: scores in the input type, the softmax in float32, its
    probabilities cast back before P·V), the partials are merged in
    rank order in float32, and each rank takes its own heads through
    W_b^V (all of them where they are whole). Returns (out (B, 1, H / M,
    v), cache)."""
    nope, hl = cfg.qk_nope_dim, q_nope.shape[2]
    lc, rc = cache["latent"], cache["k_rope"]
    pos = int(positions)  # lint: sync-ok decode passes the host's int
    group, r, mine, count = _own_slot(lc.shape[1], pos, ctx, False)
    if mine is not None:
        lc[:, mine] = latent[:, 0].to(lc.dtype)
        rc[:, mine] = k_rope[:, 0, 0].to(rc.dtype)
    wb_k, wb_v = p.wkv_b[..., :nope], p.wkv_b[..., nope:]
    q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wb_k)      # (B,1,Hl,L)
    qcat = torch.cat([q_eff, q_rope], dim=-1)                 # (B,1,Hl,L+r)
    if hl != cfg.n_heads:
        qcat = assemble(qcat, 2, group)
    kcat = torch.cat([lc, rc], dim=-1)                        # (B,Tl,L+r)
    scores = torch.einsum("bshc,btc->bhst", qcat, kcat) * scale
    valid = torch.arange(lc.shape[1], device=x.device) < count
    scores = scores.float().masked_fill(~valid, NEG_INF)
    top = scores.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - top), 0.0)
    total = e.sum(dim=-1, keepdim=True)
    probs = (e / total.clamp_min(1e-30)).to(x.dtype)
    out_l = torch.einsum("bhst,btl->bshl", probs, lc)          # (B,1,H,L)
    lse = (top + torch.log(total))[:, :, 0, 0]                 # (B,H)
    out_l = _merge_over(out_l[:, 0], lse, group).to(x.dtype)[:, None]
    if hl != cfg.n_heads:
        out_l = out_l[:, :, r * hl:(r + 1) * hl]
    return torch.einsum("bshl,lhv->bshv", out_l, wb_v), cache


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


def layer_forward(kind, p, x, *, cfg, mode, positions, cache=None,
                  prefix_len=None, ctx=None):
    """One layer ``p`` (a :class:`repro_torch.models.model.Layer`, or a
    :class:`~repro_torch.models.model.MambaLayer` for ``ssm``). Returns
    (x, aux, new_cache): ``aux`` is the router's load-balancing loss of
    a MoE layer, 0.0 for the others. ``prefix_len`` as
    :func:`attn_forward`'s; ``ctx`` (a
    :class:`~repro_torch.models.model.ShardCtx`) carries the mesh of the
    tensor-parallel attention and MLP and picks a MoE layer's dispatch
    (:func:`repro_torch.models.moe.moe_ffn`)."""
    if kind == "ssm":
        y, new_cache = mamba_forward(p, x, cfg=cfg, mode=mode, cache=cache,
                                     ctx=ctx)
        return x + y, 0.0, new_cache
    h = rms_norm(x, p.ln1)
    attn_out, new_cache = attn_forward(p.attn, h, cfg=cfg, kind=kind,
                                       mode=mode, positions=positions,
                                       cache=cache, prefix_len=prefix_len,
                                       ctx=ctx)
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p.post_ln1)
    x = x + attn_out

    h = rms_norm(x, p.ln2)
    if kind.startswith("moe"):
        ff, aux = moe_ffn(h, p.moe, cfg, ctx)
        if cfg.n_shared_experts:
            ff = ff + _ffn(p.shared_mlp, h, cfg,
                           cfg.d_ff_expert * cfg.n_shared_experts, ctx,
                           "shared experts")
    else:
        ff = _ffn(p.mlp, h, cfg, cfg.d_ff, ctx)
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


def ssm_groups(n_heads: int, n_groups: int, heads: int, rank: int
               ) -> tuple[int, int]:
    """(first group, groups) that heads ``rank · heads`` .. ``(rank + 1)
    · heads - 1`` of a scan of ``n_heads`` heads in ``n_groups`` groups
    read B and C from: whole groups, or part of one group (as every
    config's single group); a split that cuts a rank's heads across a
    group boundary is refused."""
    per = n_heads // n_groups
    if heads % per == 0:
        return rank * heads // per, heads // per
    if per % heads == 0:
        return rank * heads // per, 1
    raise ValueError(f"{heads} heads a rank do not hold whole groups of "
                     f"{per} heads ({n_heads} heads in {n_groups} groups)")


def _gated_norm(y, scale, width, ctx, eps=1e-6):
    """The zero-centred RMSNorm of ``y``, this rank's columns of a row of
    ``width``: the float32 sum of squares psummed over the model axis
    (and, by ``replicated_in``, its gradient summed back), then the
    reference's ``rms_norm`` expression on the rank's columns, in plain
    PyTorch with autograd (the ``rmsnorm`` kernel normalises only the
    row it holds)."""
    group, _, _ = model_axis(ctx, "the gated norm")
    xf = y.float()
    ss = psum(xf.square().sum(dim=-1, keepdim=True), ctx.mesh,
              (ctx.model_axis,))
    ss = replicated_in(ss, group)
    w = (1.0 + scale).to(scale.dtype)
    return (xf * torch.rsqrt(ss / width + eps) * w).to(y.dtype)


def mamba_forward(p, x, *, cfg, mode, cache=None, ctx=None):
    """Mamba-2 block ``p`` (a
    :class:`~repro_torch.models.model.MambaLayer`). Prefill and training
    run the ``ssd_scan`` kernel through its guarded entry point (whatever
    ``cfg.attn_backend`` says; its backward is the ``ssd_scan_bwd``
    kernel), decode the one-token recurrence. A layer holding H / M of
    the heads (``A_log``'s length) runs the scan over them, reading the
    B and C of their groups from the whole ``wB``/``wC``/``conv_B``/
    ``conv_C`` (see the module's notes). Returns (y (B,S,d),
    new_cache)."""
    with span("model.mamba2"):
        b, s, _ = x.shape
        g, n, pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
        h = p.A_log.shape[0]
        split = h != cfg.ssm_heads
        hidden = rms_norm(x, p.ln)
        wB, wC, conv_B, conv_C = p.wB, p.wC, p.conv_B, p.conv_C
        g0, gl = 0, g
        if split:
            group, r, _ = model_axis(ctx, "Mamba-2 heads")
            g0, gl = ssm_groups(cfg.ssm_heads, g, h, r)
            hidden = replicated_in(hidden, group)
            wB, wC, conv_B, conv_C = (replicated_in(t, group)
                                      for t in (wB, wC, conv_B, conv_C))
        z = torch.einsum("bsd,de->bse", hidden, p.wz)
        xs = torch.einsum("bsd,de->bse", hidden, p.wx)
        Bs = torch.einsum("bsd,de->bse", hidden, wB)
        Cs = torch.einsum("bsd,de->bse", hidden, wC)
        dt = torch.einsum("bsd,dh->bsh", hidden, p.wdt)
        dt = F.softplus(dt.float() + p.dt_bias)
        A = -torch.exp(p.A_log)

        def groups(t):                 # (B, S, gl, N): this rank's groups
            t = t.reshape(b, t.shape[1], g, n)
            return t if gl == g else t[:, :, g0:g0 + gl]

        if mode == "decode":
            xs, cx = _causal_conv(xs, p.conv_x, cache["conv_x"])
            Bs, cB = _causal_conv(Bs, conv_B, cache["conv_B"])
            Cs, cC = _causal_conv(Cs, conv_C, cache["conv_C"])
            xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
            y1, state = ssd_decode_step(
                cache["state"], xs.reshape(b, h, pd), dt[:, 0], A,
                groups(Bs)[:, 0], groups(Cs)[:, 0])
            y = y1.reshape(b, 1, h, pd)
            xs_r = xs.reshape(b, 1, h, pd)
            for name, t in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC),
                            ("state", state)):
                cache[name].copy_(t)
            new_cache = cache
        else:
            xs, _ = _causal_conv(xs, p.conv_x)
            Bs, _ = _causal_conv(Bs, conv_B)
            Cs, _ = _causal_conv(Cs, conv_C)
            xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
            xs_r = xs.reshape(b, s, h, pd)
            y, state = ssd_scan(xs_r.contiguous(), dt.contiguous(), A,
                                groups(Bs).contiguous(),
                                groups(Cs).contiguous(), cfg.ssm_chunk)
            if mode == "prefill":
                k = cfg.ssm_conv
                # the conv tails need the *pre-activation* streams
                new_cache = {"conv_x": _conv_tail(hidden, p.wx, k),
                             "conv_B": _conv_tail(hidden, wB, k),
                             "conv_C": _conv_tail(hidden, wC, k),
                             "state": state}
            else:
                new_cache = None

        y = y + xs_r * p.D[:, None].to(y.dtype)
        y = y.reshape(b, -1, p.gate_norm.shape[0]) * F.silu(z)
        if not split:
            return torch.einsum("bse,ed->bsd", rms_norm(y, p.gate_norm),
                                p.wout), new_cache
        y = _gated_norm(y, p.gate_norm, cfg.d_inner, ctx)
        return psum(torch.einsum("bse,ed->bsd", y, p.wout), ctx.mesh,
                    (ctx.model_axis,)), new_cache


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


@functools.lru_cache(maxsize=None)
def _shared_attn_cfg(cfg):
    """The options of the shared block's attention: causal, global, the
    head dim's scale, no softcap, no qk-norm."""
    return cfg.replace(causal=True, attn_softcap=None, attn_scale=None,
                       qk_norm=False)


def shared_block_forward(p, lora, x, emb0, *, cfg, mode, positions,
                         cache=None, ctx=None):
    """Zamba2: shared block ``p`` (a
    :class:`~repro_torch.models.model.SharedBlock`) on concat(x, emb0),
    with one slot's ``lora``, projected back to d and added to x. Its
    attention (:func:`attn_forward` with the LoRA) is causal, global,
    without softcap; the cache is a linear {"k", "v"}. Under tensor
    parallelism its heads, the LoRA's ``b_*`` and the MLP's F are split
    and ``down`` is column-parallel (see the module's notes). Returns
    (x, new_cache)."""
    h0 = torch.cat([x, emb0], dim=-1)
    h = rms_norm(h0, p.ln1)
    out, new_cache = attn_forward(p.attn, h, cfg=_shared_attn_cfg(cfg),
                                  kind="dense_global", mode=mode,
                                  positions=positions, cache=cache, ctx=ctx,
                                  lora=lora)
    h1 = h0 + out
    h2 = rms_norm(h1, p.ln2)
    h1 = h1 + _ffn(p.mlp, h2, cfg, cfg.d_ff, ctx)
    return x + column_parallel(h1, p.down, cfg.d_model, ctx, "down"), \
        new_cache
