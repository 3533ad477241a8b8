"""Plain float32 pieces shared by the families' references.

Written from the equations, in plain PyTorch: no kernel, cache or
batching, and nothing imported from the program under test. Every
product goes through :func:`mm`, which computes it in float32, or, for
the control, with both operands rounded to fp8 (e4m3, one scale a
tensor), forward and backward. Everything else is float32.

A parameter set is a dict ``{name: tensor}`` in the benchmark's layout
(``param_spec`` of a family module). The trainer holds the parameters
in float32 leaves and rounds every leaf the configuration stores in
bf16 back to bf16 after each update, as a bf16 state keeps them; the
moments are float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0                     # the largest finite float8_e4m3fn


class Leaf(NamedTuple):
    """One parameter of a family's layout: its name, shape, the type the
    state stores it in, how the benchmark draws it (``normal``: N(0, 1)
    / sqrt(fan_in); ``norm``: N(0, 0.1^2) about the zero-centred norm's
    1; ``A_log``, ``dt_bias``: Mamba-2's initialisation; ``one``), and
    ``fan_in``."""
    name: str
    shape: tuple
    dtype: str
    init: str = "normal"
    fan_in: int = 1


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one scale that maps its largest
    magnitude to the format's largest, returned in float32."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _grad_eq(eq: str, which: int) -> str:
    """The einsum giving operand ``which``'s gradient of ``eq``."""
    ins, out = eq.split("->")
    a, b = ins.split(",")
    return f"{out},{b}->{a}" if which == 0 else f"{a},{out}->{b}"


class _Fp8Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, _fp8(a), _fp8(b))

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dq = _fp8(dy)
        da = torch.einsum(_grad_eq(ctx.eq, 0), dq, _fp8(b))
        db = torch.einsum(_grad_eq(ctx.eq, 1), _fp8(a), dq)
        return None, da, db


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """The product ``einsum(eq, a, b)`` in float32 (``prec`` "fp32") or
    on fp8 operands (``prec`` "fp8", the control). Every index of an
    operand appears in the other operand or in the output."""
    a, b = a.float(), b.float()
    if prec == "fp32":
        return torch.einsum(eq, a, b)
    if prec == "fp8":
        return _Fp8Einsum.apply(eq, a, b)
    raise ValueError(f"precision {prec!r}: fp32 or fp8")


def rms_norm(x, scale, eps: float, bf16: bool):
    """Zero-centred RMSNorm: x / rms(x) * (1 + scale). With ``bf16`` (the
    scale stored in bf16) ``1 + scale`` is the bf16 sum, as the model
    forms the weight in its stored type; its gradient passes unrounded."""
    w = 1.0 + scale
    if bf16:
        w = w + (w.to(torch.bfloat16).float() - w).detach()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, the two
    halves of the head rotated against each other."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str):
    """Softmax attention of q (B, S, H, Dk) over k (B, S, H, Dk) and v
    (B, S, H, Dv) under the causal mask, scaled by Dk^-1/2."""
    s = q.shape[1]
    scores = mm("bqhd,bkhd->bhqk", q, k, prec) * q.shape[-1] ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return mm("bhqk,bkhd->bqhd", probs, v, prec)


def glu(x, wi, wo, act: str, prec: str):
    """Gated MLP: wi (D, 2, F) gate and up, wo (F, D)."""
    h = mm("bsd,dcf->bscf", x, wi, prec)
    gate, up = h[..., 0, :], h[..., 1, :]
    if act == "silu":
        a = F.silu(gate)
    elif act == "gelu_tanh":
        a = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"activation {act!r}")
    return mm("bsf,fd->bsd", a * up, wo, prec)


def cross_entropy(logits, labels):
    """Mean token cross-entropy of float32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - ll).mean()


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward: the
    reference holds one layer's activations at a time."""
    return checkpoint(fn, *args, use_reentrant=False)


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up, then cosine decay to 0 at ``total_steps``."""
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return opt["lr"] * step / max(1.0, warm)
    t = min(max((step - warm) / max(1.0, total - warm), 0.0), 1.0)
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * t))


def train_steps(family, cfg: dict, weights: dict, batches: list,
                prec: str = "fp32", routes: list | None = None) -> dict:
    """AdamW steps of ``family`` (a reference module) from ``weights``,
    one a batch, as the configuration's optimizer states them: global
    norm clip, bias-corrected moments, decoupled weight decay on every
    leaf, the loss plus ``aux_loss_weight`` times the MoE balance loss.
    Returns ``losses`` (the cross-entropy of each step), ``grad_norms``
    (each leaf's first gradient as the update took it, after the clip)
    and ``params`` (the leaves after the last step, float32 holding the
    stored type's values). Takes the leaves out of ``weights`` as it
    makes its float32 copies, so the two are not held at once.

    ``routes`` (a MoE family): the program's expert ids, a list a step
    of one (T, k) a MoE layer, which the steps take; then
    ``route_gap`` is the widest gap, in router logits, by which a token's
    expert lies below its k-th best. ``routes`` out: the experts the
    steps took, as ``routes`` in."""
    opt = cfg["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    stored = {leaf.name: leaf.dtype for leaf in family.param_spec(cfg)}
    params = {k: weights.pop(k).detach().float().requires_grad_(True)
              for k in stored}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms, gaps, taken = [], {}, [], []
    for step, batch in enumerate(batches, 1):
        record = {"gaps": [], "ids": []}
        ce, aux = family.loss(params, batch, cfg, prec,
                              routes[step - 1] if routes else None, record)
        (ce + cfg["reference"]["aux_loss_weight"] * aux).backward()
        losses.append(float(ce.detach()))
        gaps += record["gaps"]
        taken.append(record["ids"][:len(record["ids"]) // 2])
        grads = {k: p.grad for k, p in params.items()}
        gnorm = torch.sqrt(sum(g.double().square().sum() for g in
                               grads.values())).float()
        clip = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
        lr = lr_at(step, opt)
        b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * clip
                if step == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + eps) \
                    + opt["weight_decay"] * p
                new = p - lr * delta
                if stored[k] == "bfloat16":
                    new = new.to(torch.bfloat16).float()
                p.copy_(new)
                p.grad = None
        del grads
    return {"losses": losses, "grad_norms": grad_norms,
            "route_gap": max(gaps) if gaps else None, "routes": taken,
            "params": {k: p.detach() for k, p in params.items()}}
