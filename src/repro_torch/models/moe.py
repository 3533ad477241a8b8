"""Mixture-of-Experts FFN: top-k routing with softmax-renormalised
weights, and the reference's three dispatches, computing the same math:

* ``dense`` (:func:`moe_dense`) — every expert on every token, a masked
  combine. Taken without a mesh; it drops no token.
* ``a2a`` (:func:`moe_a2a`) — expert parallelism for training and
  prefill: each rank takes its chunk of the sequence, a sort-based
  capacity dispatch (:func:`_dispatch_indices`) builds per-expert
  buffers, an all-to-all over the model axis moves the copies to the
  rank that holds their expert, the local experts run, and the reverse
  all-to-all brings them back. Copies past an expert's capacity
  (``capacity_factor`` times the even share) are dropped: they write
  into a junk row and add nothing. This is the layer AMTHA's expert
  placement permutes (:func:`repro_torch.sharding.permute_expert_params`).
* ``local`` (:func:`moe_local_decode`) — decode: every rank of the model
  axis runs its own experts on all its tokens and a sum over the axis
  combines them.

The reference runs the last two inside a ``shard_map``; here each rank
is a process, and the map's boundaries are the autograd Functions of
:mod:`repro_torch.sharding.collectives`, so the ``a2a`` dispatch
trains: the router enters every rank whole (its gradient summed over the
model axis), the sequence chunk's gradient is gathered back, the
assembled output's gradient is sliced, not summed, and each rank's
``aux`` takes its share of the mean's gradient.

The expert products, the sort, the scatter and the gather are plain
large products and index operations, which the reference computes
outside any Pallas kernel: here they are PyTorch calls (cuBLAS on the
card). Routing runs in float32 whatever the model's type; the combine
sums the experts' outputs in float32 and casts back to x's type.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..launch.mesh import check_tensors, mesh_coords
from ..sharding.collectives import (all_to_all, assemble, pmean, psum,
                                    replicated_in, slice_in)
from ..spans import span


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x (T, D); w_router (D, E) -> the routing softmax (T, E) float32."""
    return torch.softmax(torch.einsum("td,de->te", x.float(),
                                      w_router.float()), dim=-1)


def route_weights(probs: torch.Tensor, ids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """probs (T, E) the routing softmax; ids (T, k) int64 the experts each
    token goes to -> (weights (T, k) float32, aux_loss () float32). The
    weights are the chosen experts' probabilities renormalised to sum to
    one; ``aux_loss`` is the Switch load-balancing loss E · sum_e f_e ·
    p_e (f_e the share of the T·k routed copies sent to expert e, p_e
    its mean probability)."""
    weights = probs.gather(1, ids)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    e = probs.shape[1]
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add_(0, ids.reshape(-1),
                       torch.ones(ids.numel(), dtype=torch.float32,
                                  device=probs.device)) / ids.numel()
    return weights, e * torch.sum(probs.mean(0) * ce)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D); w_router (D, E) -> (weights (T, k) float32, ids (T, k)
    int64, aux_loss () float32): each token's ``top_k`` most probable
    experts, weighted by :func:`route_weights`."""
    probs = router_probs(x, w_router)
    ids = torch.topk(probs, top_k, dim=-1).indices
    weights, aux = route_weights(probs, ids)
    return weights, ids, aux


def expert_ffn(xe: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
               activation: str) -> torch.Tensor:
    """xe (E, C, D) tokens grouped per expert; wi (E, D, 2, F) fused
    gate+up; wo (E, F, D) -> (E, C, D). ``geglu`` gates with tanh-GELU,
    anything else with SiLU."""
    h = torch.einsum("ecd,edxf->ecxf", xe, wi)
    gate, up = h[:, :, 0], h[:, :, 1]
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" \
        else F.silu(gate)
    return torch.einsum("ecf,efd->ecd", act * up, wo)


def moe_dense(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor, top_k: int, activation: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (y (..., D) in x's type, aux_loss). Every expert
    runs on every token; each token's output is its top-k experts'
    outputs weighted by the router, summed in float32."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    weights, ids, aux = router_topk(xt, router, top_k)
    e = router.shape[1]
    # combine weight per (token, expert); the top-k ids of a row differ
    w_te = torch.zeros((xt.shape[0], e), dtype=torch.float32,
                       device=x.device).scatter_add_(1, ids, weights)
    ys = expert_ffn(xt.expand(e, *xt.shape), wi, wo, activation)  # (E,T,D)
    y = torch.einsum("etd,te->td", ys.float(), w_te)
    return y.reshape(shape).to(x.dtype), aux


# ---------------------------------------------------------------------------
# sort-based capacity dispatch (the a2a path's)
# ---------------------------------------------------------------------------

def _dispatch_indices(ids: torch.Tensor, top_k: int, n_experts: int,
                      capacity: int):
    """ids (T, k) -> (expert_sorted, token_sorted, slot, keep, order): for
    each of the T·k routed copies in expert order (a stable sort, so
    token order within an expert), its expert, source token, slot in
    the expert's capacity buffer, whether it survived the capacity cut,
    and its index in the flat (T·k) routing."""
    tk = ids.shape[0] * top_k
    flat_e = ids.reshape(-1)
    flat_t = torch.arange(ids.shape[0], device=ids.device) \
        .repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    first = torch.searchsorted(se, se, side="left")
    slot = torch.arange(tk, device=ids.device) - first
    keep = slot < capacity
    return se, st, slot, keep, order


# ---------------------------------------------------------------------------
# a2a path (train / prefill)
# ---------------------------------------------------------------------------

def moe_a2a_local(x_loc: torch.Tensor, router: torch.Tensor,
                  wi: torch.Tensor, wo: torch.Tensor, *, top_k: int,
                  activation: str, n_experts: int, capacity_factor: float,
                  group) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's body: x_loc (T_loc, D) its tokens; ``wi`` (E_loc, D, 2,
    F) and ``wo`` (E_loc, F, D) its experts (rank r of ``group`` holds
    experts r·E_loc .. (r+1)·E_loc - 1); ``router`` (D, E) whole.
    Returns (y (T_loc, D) in x's type, this rank's aux loss)."""
    ep = dist.get_world_size(group)
    t_loc, d = x_loc.shape
    e_loc = wi.shape[0]
    if e_loc * ep != n_experts:
        raise ValueError(f"{e_loc} local experts x {ep} ranks != "
                         f"{n_experts} experts")

    weights, ids, aux = router_topk(x_loc, router, top_k)
    cap = max(1, int(t_loc * top_k / n_experts * capacity_factor))
    se, st, slot, keep, order = _dispatch_indices(ids, top_k, n_experts, cap)

    # send buffer (E, cap, D); dropped copies write into a junk row
    buf = x_loc.new_zeros((n_experts, cap + 1, d))
    buf = buf.index_put((se, torch.where(keep, slot, cap)), x_loc[st])
    send = buf[:, :cap].reshape(ep, e_loc, cap, d)

    # (ep, E_loc, cap, D) -> a2a -> (ep, E_loc, cap, D) from each source
    recv = all_to_all(send, group)
    xe = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
    ye = expert_ffn(xe, wi, wo, activation)
    back = ye.reshape(e_loc, ep, cap, d).transpose(0, 1)
    ybuf = all_to_all(back, group).reshape(n_experts, cap, d)

    # combine: gather surviving copies back to their tokens
    flat_w = weights.reshape(-1)[order]
    y_copies = ybuf[se, slot.clamp(0, cap - 1)]
    y_copies = y_copies * (flat_w * keep)[:, None].to(y_copies.dtype)
    y = torch.zeros((t_loc, d), dtype=torch.float32, device=x_loc.device)
    y = y.index_add(0, st, y_copies.float())
    return y.to(x_loc.dtype), aux


def moe_a2a(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, *, top_k: int, activation: str,
            n_experts: int, capacity_factor: float, mesh,
            dp_axes: tuple[str, ...], ep_axis: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D): this rank's data-parallel shard, whole over
    ``ep_axis``; ``wi``/``wo`` this rank's experts over ``ep_axis``,
    ``router`` whole. Each rank dispatches its chunk of the sequence
    (the reference's ``P(dp, ep)``); the output is assembled over
    ``ep_axis``, whole on every rank of it. ``aux`` is the mean over
    ``dp_axes + (ep_axis,)`` of the ranks' losses."""
    check_tensors(mesh, x, router, wi, wo)
    ep_group = mesh.get_group(ep_axis)
    x_loc = slice_in(x, 1, ep_group)
    bl, sl, d = x_loc.shape
    y, aux = moe_a2a_local(
        x_loc.reshape(bl * sl, d), replicated_in(router, ep_group), wi, wo,
        top_k=top_k, activation=activation, n_experts=n_experts,
        capacity_factor=capacity_factor, group=ep_group)
    aux = pmean(aux, mesh, tuple(dp_axes) + (ep_axis,))
    return assemble(y.reshape(bl, sl, d), 1, ep_group), aux


# ---------------------------------------------------------------------------
# local path (decode)
# ---------------------------------------------------------------------------

def moe_local_decode(x: torch.Tensor, router: torch.Tensor,
                     wi: torch.Tensor, wo: torch.Tensor, *, top_k: int,
                     activation: str, n_experts: int, mesh,
                     dp_axes: tuple[str, ...], ep_axis: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) this rank's data-parallel shard, whole over
    ``ep_axis``: each rank runs its own experts on all its tokens,
    weighted as :func:`moe_dense` weights them, and a sum over
    ``ep_axis`` combines. No all-to-all: decode batches are too small to
    split. ``aux`` is the mean over ``dp_axes`` (x is whole over the
    expert axis, so every rank of it has the same).

    The routing runs alike on every rank of ``ep_axis``; x and the
    routing weights enter each rank's own experts through
    :func:`~repro_torch.sharding.collectives.replicated_in`, so the
    gradients that reach x and the router from the experts are summed
    over the axis, and those from ``aux`` are not."""
    check_tensors(mesh, x, router, wi, wo)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, ids, aux = router_topk(xt, router, top_k)
    ep_group = mesh.get_group(ep_axis)
    weights, xe = replicated_in(weights, ep_group), replicated_in(xt, ep_group)
    e_loc = wi.shape[0]
    first = mesh_coords(mesh)[ep_axis] * e_loc
    w_te = torch.zeros((xt.shape[0], n_experts), dtype=torch.float32,
                       device=x.device).scatter_add_(1, ids, weights)
    w_local = w_te[:, first:first + e_loc]                  # (T, E_loc)
    ys = expert_ffn(xe.expand(e_loc, *xt.shape), wi, wo, activation)
    y = torch.einsum("etd,te->td", ys.float(), w_local)
    y = psum(y, mesh, (ep_axis,))
    if dp_axes:
        aux = pmean(aux, mesh, tuple(dp_axes))
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(x: torch.Tensor, p, cfg, ctx=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of a layer's ``moe`` module ``p`` (``router`` (D, E)
    float32, ``wi`` (E, D, 2, F), ``wo`` (E, F, D); under a mesh its
    experts are this rank's), dispatched on the execution context
    (:class:`~repro_torch.models.model.ShardCtx`): no mesh -> dense;
    decode -> local; else a2a."""
    with span("model.moe"):
        if ctx is None or ctx.mesh is None:
            return moe_dense(x, p.router, p.wi, p.wo, cfg.top_k,
                             cfg.activation)
        kw = dict(top_k=cfg.top_k, activation=cfg.activation,
                  n_experts=cfg.n_experts, mesh=ctx.mesh, dp_axes=ctx.dp_axes,
                  ep_axis=ctx.model_axis)
        if ctx.mode == "decode":
            return moe_local_decode(x, p.router, p.wi, p.wo, **kw)
        return moe_a2a(x, p.router, p.wi, p.wo,
                       capacity_factor=cfg.capacity_factor, **kw)
