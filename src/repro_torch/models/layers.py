"""Shared neural-net primitives of the serving and training paths
(PyTorch).

Norms and attention go through the guarded kernel entry points of
:mod:`repro_torch.kernels.ops`, looked up on the module at each call:
on a CUDA tensor they launch the hand-written kernels, on a CPU tensor
they run the kernels' plain PyTorch versions. They run inside a
``torch.autograd.Function`` whose backward is the entry point of the
backward kernel (``ops.rmsnorm_bwd``, ``ops.flash_attention_bwd``,
``ops.ssd_scan_bwd`` for the Mamba-2 scan of
:func:`repro_torch.models.blocks.mamba_forward`): autograd cannot pass
through a kernel launch. Attention takes the
Function only when a gradient is wanted, since its forward then also
writes the log-sum-exp the backward reads. Everything else is plain PyTorch, differentiated by autograd.
Layouts are the JAX package's: activations (B, S, d), heads as explicit
axes (B, S, H, Dh).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -2.0e38          # a masked score: exp() of it underflows to 0


# ---------------------------------------------------------------------------
# norms / activations / embeddings
# ---------------------------------------------------------------------------

class RMSNormFn(torch.autograd.Function):
    """``ops.rmsnorm`` forward, ``ops.rmsnorm_bwd`` backward (the weight
    as given, ``zero_centered=False``)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return ops.rmsnorm(x, w, eps=eps, zero_centered=False)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ops.rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps,
                                 zero_centered=False)
        return dx, dw, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` follows gemma ((1+w)·x̂). As in the
    reference model, ``1 + scale`` is formed in the weight's type (so
    rounded to bfloat16 for bfloat16 weights) before the float32 product;
    the kernel itself would add in float32, so the sum is passed with
    ``zero_centered=False`` (and autograd carries its gradient to
    ``scale``)."""
    w = (1.0 + scale).to(scale.dtype) if zero_centered else scale
    return RMSNormFn.apply(x.contiguous(), w, eps)


class SSDScanFn(torch.autograd.Function):
    """``ops.ssd_scan`` forward, keeping its inputs; ``ops.ssd_scan_bwd``
    backward, which takes the gradient of the final state too (None when
    nothing used it) and gives x, dt, A, B and C theirs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ops.ssd_scan(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dfinal = None if dfinal is None else dfinal.contiguous()
        return (*ops.ssd_scan_bwd(x, dt, A, B, C, dy, dfinal, ctx.chunk),
                None)


def ssd_scan(x, dt, A, B, C, chunk: int):
    """The Mamba-2 SSD scan through the ``ssd_scan`` kernel (and, when a
    gradient is wanted, its backward kernel): (y, final state)."""
    return SSDScanFn.apply(x, dt, A, B, C, chunk)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def glu_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
            activation: str) -> torch.Tensor:
    """wi: (d, 2, F) fused gate+up; wo: (F, d). activation in
    {geglu, swiglu, gelu, relu2}; non-GLU activations use wi[:, 0]."""
    if activation in ("geglu", "swiglu"):
        h = torch.einsum("...d,dcf->...cf", x, wi)
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.gelu(gate, approximate="tanh") if activation == "geglu" \
            else F.silu(gate)
        h = act * up
    else:
        h = torch.einsum("...d,df->...f", x, wi[:, 0])
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh") if activation == "gelu" \
            else torch.square(F.relu(h))
    return torch.einsum("...f,fd->...d", h, wo)


def embed_scale(x: torch.Tensor, d: int) -> torch.Tensor:
    """x · sqrt(d) in x's type: the gemma family's embedding scale."""
    return x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 scale_by_dim: bool = False) -> torch.Tensor:
    out = table[tokens]
    return embed_scale(out, table.shape[1]) if scale_by_dim else out


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: an int or a tensor broadcastable to
    (..., S). Split-half rotation in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    pos = torch.as_tensor(positions, device=x.device)
    angles = pos[..., None].to(torch.float32) * freqs       # (..., S, dh/2)
    sin = torch.sin(angles)[..., None, :]                   # (..., S, 1, dh/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention — prefill and decode
# ---------------------------------------------------------------------------

class FlashAttentionFn(torch.autograd.Function):
    """``ops.flash_attention(return_lse=True)`` forward, keeping (q, k,
    v, out, lse); ``ops.flash_attention_bwd`` backward: the reference's
    custom VJP ``_flash_fwd``/``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, causal, scale, window, softcap,
                q_offset):
        kw = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                  prefix_len=prefix_len, q_offset=q_offset)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse, prefix_len)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, prefix_len = ctx.saved_tensors
        kw = dict(ctx.kw, prefix_len=prefix_len)
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                             lse, **kw)
        return dq, dk, dv, None, None, None, None, None, None


def attention(q, k, v, *, causal=True, window=None, scale=None,
              attn_softcap=None, prefix_len=None, q_offset: int = 0):
    """Prefill attention, q (B, Sq, Hq, D) against k/v (B, Sk, Hkv,
    D[v]), through the ``flash_attention`` kernel (and, when a gradient is
    wanted, its backward kernel). ``window`` selects the local
    (sliding-window) mask; ``prefix_len`` (B,) the prefix-LM mask of a
    VLM, under which keys before the prefix length are visible from
    every query (the reference's ``attention_streamed`` prefix branch).
    ``q_offset`` (a host int) is the global position of q's first row
    when q is one rank's chunk of the sequence and k/v cover all of it
    (sequence-parallel attention, the reference's ``q_offset``); the
    kernels take it, so no path falls back to the plain version."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if prefix_len is not None:
        prefix_len = prefix_len.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, prefix_len, causal, scale,
                                      window, attn_softcap, q_offset)
    return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window, softcap=attn_softcap,
                               prefix_len=prefix_len, q_offset=q_offset)


def attention_decode(q, k_cache, v_cache, *, pos, scale=None,
                     attn_softcap=None, ring=False, return_lse=False):
    """One-token decode, q (B, 1, Hq, D) against a (B, T, Hkv, D[v])
    cache, through the ``flash_decode`` kernel. ``pos`` (an int or a (B,)
    tensor) is the absolute position of the token just inserted; slots
    ``< pos + 1`` are valid, capped at T for a ``ring`` buffer. (The
    reference's unused ``attention_decode`` took the count of valid
    entries and an explicit window instead; the model's ring caches
    carry the window.) Returns (B, 1, Hq, Dv); with ``return_lse`` a
    float32 (B, 1, Hq, Dv) and the (B, Hq) float32 log-sum-exp, and
    ``pos`` may be -1 (no valid slot: one slot range of a cache split
    over ranks)."""
    b = q.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos_b = pos_b.expand(b).contiguous() if pos_b.dim() == 0 else pos_b
    out = ops.flash_decode(q[:, 0].contiguous(), k_cache, v_cache, pos_b,
                           scale=scale, softcap=attn_softcap, ring=ring,
                           return_lse=return_lse)
    if return_lse:
        return out[0][:, None], out[1]
    return out[:, None]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  logit_softcap: float | None = None,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in float32 with an optional z-loss, as
    the reference's ``cross_entropy``."""
    logits = softcap(logits.float(), logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss
