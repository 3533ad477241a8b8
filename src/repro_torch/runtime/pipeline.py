"""Pipeline parallelism over the ``pod`` axis, planned by AMTHA.

The paper's algorithm assigns layer blocks to pods
(:func:`repro_torch.core.placement.assign_layers_to_pods`: tasks = layer
blocks, comm edges = activation volumes, the inter-node link the slow
level); this module *executes* that assignment as a GPipe-style
pipeline, as the reference's ``runtime/pipeline.py`` does:

* rank p of the ``pod`` axis runs only stage p's layers, a contiguous
  range of equal length (:func:`stage_layer_range`, the counterpart of
  the reference's ``restack_for_stages``);
* microbatches advance one stage per tick; activations hop to the next
  pod by a point-to-point shift (the reference's ``ppermute``); the
  schedule runs n_micro + n_stages − 1 ticks (bubble fraction
  (S−1)/(T+S−1));
* the whole pipeline is differentiable: the shift's backward sends the
  gradient to the previous pod.

Scope: the stage body is local compute (no mesh inside a stage). The
reference leaves pipeline × tensor parallelism (a model axis inside a
stage) documented and unbuilt (its ``runtime/pipeline.py`` docstring),
and so does the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.machine import H100_IB_BW, H100_PEAK_FLOPS
from ..core.placement import assign_layers_to_pods
from ..launch.mesh import (axis_ranks, axis_sizes, check_tensors,
                           mesh_coords)
from ..sharding.collectives import psum, replicated_in

__all__ = ["gpipe", "make_pipelined_forward", "plan_stages",
           "predicted_pipeline_time", "stage_layer_range"]

#: GPUs in one pod: an HGX H100 node
NODE_GPUS = 8


def plan_stages(n_layers: int, n_pods: int, layer_flops: float,
                act_bytes: float, *, pod_speed_flops: float | None = None,
                link_bandwidth: float | None = None,
                link_latency: float = 1e-5):
    """AMTHA stage plan for homogeneous pods. Returns layers-per-stage
    and the assignment (``layer_to_pod``, ``comm_time``, ``t_stage``),
    as the reference's ``plan_stages``; the executable layout needs equal
    contiguous stages.

    The per-microbatch tick ``t_stage`` charges the inter-stage
    activation hop (``link_latency + act_bytes / link_bandwidth``) on top
    of the compute term, so the predicted pipeline time ``(n_micro + S
    - 1) * t_stage`` counts what each extra stage costs.

    The reference's pod is 256 TPU v5e chips at their peak, joined by
    one chip's inter-pod rate. The port's pod is one 8-GPU H100 node
    (:func:`repro_torch.core.machine.h100_node`): by default
    ``pod_speed_flops`` is 8 GPUs at the datasheet bf16 peak, and
    ``link_bandwidth`` one GPU's InfiniBand port, the inter-node level
    AMTHA maps over."""
    if n_layers % n_pods:
        raise ValueError("equal stages required for the layout")
    speed = pod_speed_flops if pod_speed_flops is not None \
        else H100_PEAK_FLOPS * NODE_GPUS
    bw = link_bandwidth if link_bandwidth is not None else H100_IB_BW
    sa = assign_layers_to_pods([layer_flops] * n_layers,
                               [act_bytes] * (n_layers - 1),
                               [speed] * n_pods)
    per = n_layers // n_pods
    sa.comm_time = (link_latency + act_bytes / bw) if n_pods > 1 else 0.0
    sa.t_stage = per * layer_flops / speed + sa.comm_time
    return per, sa


def predicted_pipeline_time(t_stage: float, n_stages: int,
                            n_micro: int) -> float:
    """GPipe fill-drain schedule length for a balanced plan: the pipeline
    runs ``n_micro + n_stages - 1`` ticks of the bottleneck stage time."""
    return (n_micro + n_stages - 1) * t_stage


# ---------------------------------------------------------------------------
# the shift between stages, and the order of its backward
# ---------------------------------------------------------------------------

def _p2p(send, send_to, recv, recv_from, group):
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, recv, recv_from, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv


class _Shift(torch.autograd.Function):
    """y to the next pod, the previous pod's y in (zeros on pod 0), as
    the reference's ``ppermute`` over ``[(i, i + 1)]``; the backward
    sends the gradient back. ``token`` in and out chains every tick's
    shift, so each rank runs the shifts' backwards in reverse tick order
    and every send meets its receive."""

    @staticmethod
    def forward(ctx, y, token, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        recv = torch.zeros_like(y, memory_format=torch.contiguous_format)
        return _p2p(y, nxt, recv, prev, group), token.new_empty(0)

    @staticmethod
    def backward(ctx, g, g_token):
        recv = torch.zeros_like(g, memory_format=torch.contiguous_format)
        g_y = _p2p(g, ctx.prev, recv, ctx.nxt, ctx.group)
        return g_y, torch.zeros(0, device=g.device), None, None, None


class _Tie(torch.autograd.Function):
    """``x`` unchanged; in the backward, ``deps`` get zero gradients, so
    their graphs run backward on this rank whether or not ``x`` reads
    them."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=dv)
                     for s, t, dv in ctx.shapes))


def gpipe(stage_fn, stage_params, x_micro: torch.Tensor, *, pod_axis: str,
          mesh) -> torch.Tensor:
    """Run the pipeline. ``stage_params``: this rank's stage (rank p of
    ``pod_axis`` holds stage p); ``x_micro``: (n_micro, B_m, S, d)
    embedded inputs, whole on every rank; ``stage_fn(stage_params, x) ->
    x`` applies one stage. Returns (n_micro, B_m, S, d) after every
    stage, whole on every rank.

    Tick t runs microbatch t − p on pod p, where it is in range (the
    reference computes the others too and masks them away); pod 0 reads
    ``x_micro``, the others the previous pod's output. The last pod's
    outputs are summed over the pods, the others adding zeros (the
    reference's masked psum); that sum's gradient is the identity, and
    ``x_micro``'s gradient is summed over the pods. Every rank of the
    pod axis runs the forward, and the backward of whatever it computes
    from the result."""
    check_tensors(mesh, x_micro)
    n_micro = x_micro.shape[0]
    p = mesh_coords(mesh)[pod_axis]
    n_pods = axis_sizes(mesh)[pod_axis]
    group = mesh.get_group(pod_axis)
    # the neighbours by coordinate, from the mesh: in a permuted mesh
    # (autoplace.stage_mesh) a rank's index in the axis group is not
    # its coordinate
    ranks = axis_ranks(mesh, pod_axis)
    prev = ranks[p - 1] if p > 0 else None
    nxt = ranks[p + 1] if p + 1 < n_pods else None

    xm = replicated_in(x_micro, group)
    # every shift's output must carry a gradient on every rank, whatever
    # that rank computed: its receiver's gradient goes back through it
    token = xm.new_empty(0).requires_grad_(torch.is_grad_enabled())
    if xm.requires_grad:
        token = _Tie.apply(token, xm)
    buf = torch.zeros_like(xm[0])
    outs = [None] * n_micro
    for t in range(n_micro + n_pods - 1):
        mb = t - p
        y = buf
        if 0 <= mb < n_micro:
            y = stage_fn(stage_params, xm[mb] if p == 0 else buf)
            if p == n_pods - 1:
                outs[mb] = y
        buf, token = _Shift.apply(y, token, prev, nxt, group)
    out = torch.stack(outs) if p == n_pods - 1 else torch.zeros_like(xm)
    return psum(_Tie.apply(out, token, buf), mesh, (pod_axis,))


def stage_layer_range(cfg, n_stages: int, stage: int) -> range:
    """The layers of stage ``stage`` when the config's repeat units are
    split into ``n_stages`` contiguous equal stages: the executable form
    of AMTHA's stage plan (the reference's ``restack_for_stages``
    reshapes the stacked units the same way)."""
    _, n_rep, unit, _ = cfg.repeat_structure()
    if n_rep % n_stages:
        raise ValueError(f"{n_rep} repeat units do not split into "
                         f"{n_stages} equal stages")
    per = n_rep // n_stages * len(unit)
    return range(stage * per, (stage + 1) * per)


def make_pipelined_forward(cfg, mesh, n_stages: int, pod_axis: str = "pod"):
    """Pipelined LM forward for repeat-only archs (no prologue, tail or
    shared block): embed (on every rank) -> the stages over the pods ->
    head (on every rank). The repeat unit may hold several layer kinds
    (gemma2's local/global pair): a stage runs whole units, so any
    ``n_stages`` dividing the units is executable; it must equal the pod
    axis' size. Returns ``fn(model, tokens (n_micro, B_m, S)) -> logits
    (n_micro, B_m, S, V)``, which reads only this rank's stage of
    ``model.layers``; the layers of the other stages may be dropped."""
    from ..models.model import ShardCtx, _embed, _head
    prologue, _, _, tail = cfg.repeat_structure()
    if prologue or tail or cfg.shared_attn_every:
        raise ValueError("pipelined path supports repeat-only archs")
    if axis_sizes(mesh)[pod_axis] != n_stages:
        raise ValueError(f"{n_stages} stages on a {pod_axis} axis of "
                         f"{axis_sizes(mesh)[pod_axis]}")
    ctx = ShardCtx(mode="train")

    def stage_fn(layers, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in layers:
            x, _, _ = layer(x, cfg=cfg, mode="train", positions=positions,
                            ctx=ctx)
        return x

    def fwd(model, tokens_micro):
        stage = stage_layer_range(cfg, n_stages,
                                  mesh_coords(mesh)[pod_axis])
        layers = [model.layers[i] for i in stage]
        emb = torch.stack([_embed(model, {"tokens": t}, cfg)[0]
                           for t in tokens_micro])
        y = gpipe(stage_fn, layers, emb, pod_axis=pod_axis, mesh=mesh)
        return torch.stack([_head(model, h, cfg) for h in y])

    return fwd
