"""AdamW in plain PyTorch, a copy of the reference's ``optim/adamw.py``:

* float32 moments whatever the parameter type (bf16 parameters update
  in float32 and are cast back);
* global-norm clipping;
* warmup + cosine learning-rate schedule;
* optional int8 gradient compression with error feedback (symmetric
  per-tensor quantize -> dequantize of gradient + residual; the residual
  is kept), at the point where a compressed reduce-scatter would sit.

Parameters, gradients and moments are dicts of tensors keyed by
parameter name (``Model.named_parameters()``). :func:`apply_updates`
updates in place: the parameters (under ``torch.no_grad``), the moments
and the error-feedback residual, so a step holds one set of moments and
not two (at gemma2-2b's 2.6 B parameters a second set is 21 GB). The
step counter and every scalar stay on the parameters' device: a step
reads nothing back to the host.

Under a mesh the parameters, gradients and moments are this rank's
slices (:func:`repro_torch.sharding.shard_params`; the moments keep the
parameters' layout, ZeRO-1 is ROADMAP A13b3) and the clip reads the
norm of the whole gradient: :func:`global_norm` with the parameters'
specs adds each sharded gradient's slices over the axes that split it,
and counts a replicated one once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..sharding.partition import spec_axes


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compression: str = "none"        # none | int8


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup,
    then cosine decay to 0 at ``total_steps``."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                         - cfg.warmup_steps)
    cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, cfg: OptConfig) -> dict:
    """{"m", "v" (float32 zeros per parameter), "step" (int32 0), and
    "ef" (float32 zeros) under int8 compression}; ``params`` a module or
    a dict of tensors."""
    named = _named(params)

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in named.items()}
    device = next(iter(named.values())).device
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compression == "int8":
        state["ef"] = zeros()            # error-feedback accumulator
    return state


def global_norm(tree: dict, specs: dict | None = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32. With
    ``specs`` (``{name: Spec}``, the layout each tensor is this rank's
    slice of on ``mesh``), each sharded tensor's sum of squares is first
    summed over the axes its spec names, so the norm is the whole
    tree's on every rank; the sums are added in the tree's order either
    way, so a mesh of one rank gives the one-device bits."""
    sums = torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree.values()])
    if specs:
        by_axes = {}
        for i, k in enumerate(tree):
            axes = spec_axes(specs[k])
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            part = sums[idx]
            for a in axes:
                dist.all_reduce(part, group=mesh.get_group(a))
            sums[idx] = part
    return torch.sqrt(torch.sum(sums))


def _quantize_int8(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize -> dequantize."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-30
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def apply_updates(params, grads: dict, state: dict, cfg: OptConfig,
                  specs: dict | None = None, mesh=None):
    """One AdamW step. ``params`` a module or a dict of tensors,
    ``grads`` a dict of the same names (any float type); ``specs`` and
    ``mesh`` as :func:`global_norm`'s, where they are this rank's slices.
    Updates the parameters, ``state["m"]``, ``state["v"]`` and
    ``state["ef"]`` in place; returns (params, state with the new
    ``step``, stats {"grad_norm", "lr"} as float32 tensors)."""
    named = _named(params)
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if cfg.compression == "int8" and specs and any(
            spec_axes(s) for s in specs.values()):
        raise NotImplementedError("int8 gradient compression of sharded "
                                  "parameters (a per-tensor scale over "
                                  "their slices) comes with ZeRO-1, "
                                  "ROADMAP A13b3")

    if cfg.compression == "int8":
        # error feedback: compress (grad + residual), keep the residual
        for k, g in grads.items():
            summed = g + state["ef"][k]
            comp = _quantize_int8(summed)
            state["ef"][k].copy_(summed - comp)
            grads[k] = comp

    gnorm = global_norm(grads, specs, mesh)
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    step = state["step"] + 1
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    with torch.no_grad():
        for k, p in named.items():
            g = grads.pop(k) * clip
            m, v = state["m"][k], state["v"][k]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            del g
            pf = p.to(torch.float32)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
