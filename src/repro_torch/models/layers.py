"""Shared neural-net primitives of the serving path (PyTorch).

Norms and attention go through the guarded kernel entry points of
:mod:`repro_torch.kernels.ops`, looked up on the module at each call:
on a CUDA tensor they launch the hand-written kernels, on a CPU tensor
they run the kernels' plain PyTorch versions. Everything else is plain
PyTorch. Layouts are the JAX package's: activations (B, S, d), heads as
explicit axes (B, S, H, Dh).
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

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` follows gemma ((1+w)·x̂). As in the
    reference model, ``1 + scale`` is formed in the weight's type (so
    rounded to bfloat16 for bfloat16 weights) before the float32 product;
    the kernel itself would add in float32, so the sum is passed with
    ``zero_centered=False``."""
    w = (1.0 + scale).to(scale.dtype) if zero_centered else scale
    return ops.rmsnorm(x.contiguous(), w, eps=eps, zero_centered=False)


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
        h = F.gelu(h) if activation == "gelu" else torch.square(F.relu(h))
    return torch.einsum("...f,fd->...d", h, wo)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 scale_by_dim: bool = False) -> torch.Tensor:
    out = table[tokens]
    if scale_by_dim:     # gemma family scales embeddings by sqrt(d)
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype,
                                 device=out.device)
    return out


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

def attention(q, k, v, *, causal=True, window=None, scale=None,
              attn_softcap=None):
    """Prefill attention, q (B, S, Hq, D) against k/v (B, S, Hkv, D[v]),
    through the ``flash_attention`` kernel. ``window`` selects the local
    (sliding-window) mask. The reference's prefix-LM and
    sequence-parallel options belong to families and meshes this port
    does not serve yet."""
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, window=window,
                               softcap=attn_softcap)


def attention_decode(q, k_cache, v_cache, *, pos, scale=None,
                     attn_softcap=None, ring=False):
    """One-token decode, q (B, 1, Hq, D) against a (B, T, Hkv, D[v])
    cache, through the ``flash_decode`` kernel. ``pos`` (an int or a (B,)
    tensor) is the absolute position of the token just inserted; slots
    ``< pos + 1`` are valid, capped at T for a ``ring`` buffer. (The
    reference's unused ``attention_decode`` took the count of valid
    entries and an explicit window instead; the model's ring caches
    carry the window.) Returns (B, 1, Hq, Dv)."""
    b = q.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos_b = pos_b.expand(b).contiguous() if pos_b.dim() == 0 else pos_b
    out = ops.flash_decode(q[:, 0].contiguous(), k_cache, v_cache, pos_b,
                           scale=scale, softcap=attn_softcap, ring=ring)
    return out[:, None]
