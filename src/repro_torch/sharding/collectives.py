"""The boundaries of the reference's ``shard_map`` as autograd Functions
over ``torch.distributed``.

Inside a ``shard_map`` each device runs plain code on its block, plus
explicit collectives; JAX derives the backward of every boundary from
the specs. In the port each rank is a process and holds its block
already, so each boundary is a Function whose backward is the transpose
JAX would take. A value every rank of a group holds whole (replicated)
carries, on every rank, the whole gradient of the loss with respect to
it, as the reference's replicated values do: the backward of a
collective whose result is replicated passes that gradient on once, not
once a rank.

* :func:`replicated_in` — an input every rank holds whole (``P()``), or
  a replicated value that enters per-rank work: the forward is the
  identity, the backward sums the ranks' gradients (the transpose of a
  replicated input is a psum).
* :func:`slice_in` — an input every rank of the group holds whole, of
  which each takes its chunk (``P(..., axis)``): the backward
  all-gathers the chunks' gradients, so every rank holds the whole
  gradient.
* :func:`assemble` — per-rank chunks joined into one tensor every rank
  holds (an output sharded over the axis): the backward takes this
  rank's chunk of the gradient, a slice and not a sum (``all_gather``'s
  own backward would sum the ranks' equal gradients, counting them
  group-size times).
* :func:`psum`, :func:`pmean` — the sum and the mean over one or several
  mesh axes, which every rank then holds alike: the backward passes the
  gradient through (divided by the ranks counted, for the mean), where
  ``torch.distributed.nn.functional.all_reduce``'s backward would sum
  the ranks' equal gradients.
* :func:`all_to_all` — ``all_to_all_single`` over dim 0 in equal splits,
  autograd-aware (its backward is the reverse all-to-all).
* :func:`fsdp_gather` — a weight FSDP keeps cut over the data axes
  along one dim (each data rank its chunk), gathered whole over them:
  the backward reduce-scatters the gradient back to this rank's chunk,
  summed over the data ranks (each ran its own rows through the whole
  weight). Dividing that sum into a mean is the train step's.

``group`` is a mesh axis' process group (``mesh.get_group(axis)``); a
rank's index in it is its index along the axis.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dnn

from ..launch.mesh import axis_sizes

__all__ = ["all_to_all", "assemble", "fsdp_gather", "pmean", "psum",
           "replicated_in", "slice_in"]


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def _join(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SliceIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _join(g, ctx.dim, ctx.group), None, None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _join(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group).contiguous(), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


# ``all_gather_into_tensor`` and ``reduce_scatter_tensor``, under the
# names newer releases give them
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's chunks of ``x`` joined along ``dim`` in group-rank
    order (one ``all_gather_into_tensor`` on dim 0)."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x, group=group)
    return out.movedim(0, dim)


def _scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``g`` over the group
    (one ``reduce_scatter_tensor`` on dim 0)."""
    n = dist.get_world_size(group)
    g = g.movedim(dim, 0).contiguous()
    out = torch.empty((g.shape[0] // n, *g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    _reduce_scatter(out, g, group=group)
    return out.movedim(0, dim)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for group in reversed(groups):          # the minor axis first
            x = _gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:                # the major axis first
            g = _scatter_dim(g, ctx.dim, group)
        return g.contiguous(), None, None


def fsdp_gather(x: torch.Tensor, dim: int, mesh,
                axes: tuple[str, ...]) -> torch.Tensor:
    """The whole of ``x`` along ``dim`` from the ranks of ``mesh`` that
    differ only along ``axes`` (the data axes, the first major; each
    holds its chunk, as :func:`repro_torch.sharding.partition.shard`
    cuts it), gathered the minor axis first as
    :func:`~repro_torch.sharding.partition.gather` does. The gradient of
    ``x`` is this rank's chunk of the sum of the ranks' gradients of the
    result: a reduce-scatter an axis, in the reverse order."""
    return _FsdpGather.apply(x, dim, tuple(mesh.get_group(a) for a in axes))


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held whole by every rank of ``group``; its gradient is the
    sum of the ranks' gradients."""
    return _ReplicatedIn.apply(x, group)


def slice_in(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (chunk i for group rank
    i); the gradient of ``x`` is the ranks' chunks' gradients joined."""
    return _SliceIn.apply(x, dim, group)


def assemble(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' chunks ``x`` joined along ``dim`` in group-rank order,
    on every rank; the gradient of ``x`` is this rank's chunk of the
    result's gradient."""
    return _Assemble.apply(x, dim, group)


def psum(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` that differ only along
    ``axes``, which every one of them then holds and uses alike: one
    all-reduce an axis, over the mesh's own group of it; the gradient
    passes through unchanged."""
    for axis in axes:
        x = _Psum.apply(x, mesh.get_group(axis))
    return x


def pmean(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The mean of ``x`` over ``axes`` (:func:`psum` over the ranks
    counted); the gradient is divided alike."""
    sizes = axis_sizes(mesh)
    return psum(x, mesh, axes) / math.prod(sizes[a] for a in axes)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``x``'s dim 0 to group rank j; chunk j of the result
    from group rank j."""
    x = x.contiguous()
    return dnn.all_to_all_single(torch.empty_like(x), x, group=group)
