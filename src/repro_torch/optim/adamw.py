"""AdamW, a copy of the reference's ``optim/adamw.py``:

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
reads nothing back to the host. The gradients' sums of squares and the
update run through :func:`repro_torch.kernels.ops.grad_sumsq` and
:func:`repro_torch.kernels.ops.adamw_update`, over every tensor at once:
on the card multi-tensor CUDA kernels, a fixed number of launches
whatever the number of tensors, the gradients read in their own type;
on the CPU the plain expressions, one tensor at a time.

Under a mesh the parameters and gradients are this rank's slices
(:func:`repro_torch.sharding.shard_params`) and the moments may be cut
finer (ZeRO-1: :meth:`repro_torch.sharding.Partitioner.moment_specs`
adds the data axes on a dim the parameter's spec leaves whole).
:func:`apply_updates` takes this rank's slice of each averaged gradient
at its moment's spec, updates its slices of the moments and of the
parameter in float32, and all-gathers the new parameter slices over the
data axes. The clip reads the norm of the whole gradient:
:func:`global_norm` with the moments' specs adds each sharded
gradient's slices over the axes that split it, and counts a replicated
one once. int8 compression takes its per-tensor scale over every slice
(an all-reduce MAX of ``max |g|``; the max is exact, so each rank's
slice of the result is bit for bit the one-device tensor's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..kernels import ops
from ..sharding.partition import Spec, gather, shard_slices, spec_axes
from ..spans import span


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


def init_opt_state(params, cfg: OptConfig,
                   shapes: dict | None = None) -> dict:
    """{"m", "v" (float32 zeros per parameter), "step" (int32 0), and
    "ef" (float32 zeros) under int8 compression}; ``params`` a module or
    a dict of tensors; ``shapes`` ({name: shape}) the moments' shapes
    where they are not the parameters' (this rank's ZeRO-1 slices)."""
    named = _named(params)
    shapes = shapes or {}

    def zeros():
        return {k: torch.zeros(shapes.get(k, p.shape), dtype=torch.float32,
                               device=p.device) for k, p in named.items()}
    device = next(iter(named.values())).device
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.compression == "int8":
        state["ef"] = zeros()            # error-feedback accumulator
    return state


def _over_slices(vals: torch.Tensor, names, specs: dict | None, mesh,
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``vals`` (one per name, stacked) each reduced by ``op`` over the
    axes the name's spec in ``specs`` shards its tensor over: one
    all-reduce an axis for every tensor sharded alike."""
    by_axes = {}
    for i, k in enumerate(names):
        axes = spec_axes(specs[k]) if specs else ()
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        part = vals[idx]
        for a in axes:
            dist.all_reduce(part, op=op, group=mesh.get_group(a))
        vals[idx] = part
    return vals


def global_norm(tree: dict, specs: dict | None = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32. With
    ``specs`` (``{name: Spec}``, the layout each tensor is this rank's
    slice of on ``mesh``), each sharded tensor's sum of squares is first
    summed over the axes its spec names, so the norm is the whole
    tree's on every rank; the sums are added in the tree's order either
    way, so a mesh of one rank gives the one-device bits."""
    sums = ops.grad_sumsq(list(tree.values()))
    return torch.sqrt(torch.sum(_over_slices(sums, list(tree), specs,
                                             mesh)))


def _quantize_int8(g: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize -> dequantize, the scale from
    the whole tensor's ``max |g|``."""
    scale = amax / 127.0 + 1e-30
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def _finer(pspec, mspec) -> Spec | None:
    """The spec that cuts a parameter's slice (at ``pspec``) down to its
    moments' (at ``mspec``): the axes ZeRO-1 put on dims the parameter
    holds whole. None where the two agree."""
    n = max(len(pspec), len(mspec))
    ps, ms = (list(x) + [None] * (n - len(x)) for x in (pspec, mspec))
    if ps == ms:
        return None
    if any(a is not None and a != b for a, b in zip(ps, ms)):
        raise ValueError(f"moment spec {mspec} does not refine the "
                         f"parameter's {pspec}")
    return Spec(*(b if a is None else None for a, b in zip(ps, ms)))


def _narrow(t: torch.Tensor, cut, mesh) -> torch.Tensor:
    return t if cut is None else t[shard_slices(t.shape, cut, mesh)]


def apply_updates(params, grads: dict, state: dict, cfg: OptConfig,
                  specs: dict | None = None, mesh=None,
                  moment_specs: dict | None = None):
    """One AdamW step. ``params`` a module or a dict of tensors,
    ``grads`` a dict of the same names (any float type, the gradient
    averaged over the data ranks); ``specs`` and ``mesh`` as
    :func:`global_norm`'s, where they are this rank's slices, and
    ``moment_specs`` (default ``specs``) the specs of ``state``'s
    moments: where one cuts a dim its parameter holds whole (ZeRO-1),
    this rank updates that slice of the parameter and all-gathers it.
    Updates the parameters, ``state["m"]``, ``state["v"]`` and
    ``state["ef"]`` (at the moments' specs) in place; returns (params,
    state with the new ``step``, stats {"grad_norm", "lr"} as float32
    tensors)."""
    with span("optim.adamw"):
        named = _named(params)
        mspecs, cuts = specs, dict.fromkeys(named)
        if moment_specs is not None:
            mspecs = moment_specs
            cuts = {k: _finer(specs[k], mspecs[k]) for k in named}
        # this rank's slice of each gradient, contiguous, in its own type
        grads = {k: _narrow(g, cuts[k], mesh).contiguous()
                 for k, g in grads.items()}

        if cfg.compression == "int8":
            # error feedback: compress (grad + residual), keep the residual;
            # the scale is the whole tensor's, the sum formed again after it
            ef = state["ef"]
            grads = {k: g.to(torch.float32) for k, g in grads.items()}
            amax = _over_slices(torch.stack([torch.max(torch.abs(g + ef[k]))
                                             for k, g in grads.items()]),
                                list(grads), mspecs, mesh, dist.ReduceOp.MAX)
            for (k, g), m in zip(list(grads.items()), amax):
                summed = g + ef[k]
                grads[k] = _quantize_int8(summed, m)
                ef[k].copy_(summed - grads[k])

        gnorm = global_norm(grads, mspecs, mesh)
        clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

        step = state["step"] + 1
        stepf = step.to(torch.float32)
        lr = schedule(stepf, cfg)
        # b1 and b2 as a Python scalar base: a torch.tensor from a Python
        # float is a blocking copy from the host
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)

        with torch.no_grad():
            # this rank's slice of each parameter, updated in place (a
            # copy where the slice is not contiguous)
            work = {k: _narrow(p, cuts[k], mesh).contiguous()
                    for k, p in named.items()}
            ops.adamw_update(list(work.values()), [grads[k] for k in work],
                             [state["m"][k] for k in work],
                             [state["v"][k] for k in work], clip=clip, lr=lr,
                             b1c=b1c, b2c=b2c, b1=cfg.b1, b2=cfg.b2,
                             eps=cfg.eps, weight_decay=cfg.weight_decay)
            del grads
            for k, p in named.items():
                if cuts[k] is not None:       # the slices joined over data
                    p.copy_(gather(work[k], cuts[k], mesh))
                elif work[k] is not p:
                    p.copy_(work[k])
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
