"""Explicit SPMD over a ``DeviceMesh``: a rank's coordinates and blocks,
and the collectives of the port's per-rank bodies, with their gradients.

Every rank runs the same program on replicated values.  A body that the
JAX package writes as a ``shard_map`` slices its rank's block of each
input by the body's input spec (``local_block``), runs with real
``torch.distributed`` collectives on the mesh's dimension groups
(``mesh.get_group(axis)``), and restores the global value by its output
spec (``gather_block``); on the partitioned program's DTensors a body
takes each rank's block as it lies (``DTensor.to_local``, with its
gradient's placements declared) and returns a DTensor
(``models.moe._moe_ffn_ep``).  On replicated values the gradients keep
every rank's copy whole:

  * a block taken from a replicated value gets the gradient that every
    rank whose block differs computed, summed over those ranks
    (``sum_grads`` before the slice);
  * a gathered output whose consumers are replicated hands each rank back
    its own block of the (identical) gradient (``gather(..., grad='slice')``);
  * a gather whose consumers differ across the axis sums their gradients
    back onto the owner's block (``grad='sum'``, a reduce-scatter), as the
    transpose of JAX's ``all_gather``;
  * ``all_to_all`` sends the gradient back the way it came.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import P, entry_axes, mesh_axes


def coord(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def block(mesh, axes) -> tuple:
    """(this rank's block index, the block count) over ``axes``, the first
    axis the major one."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord(mesh, a)
        n *= sizes[a]
    return idx, n


def local_block(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's block of the replicated ``x`` under ``spec``."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            i, n = block(mesh, axes)
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x


def gather_block(x: torch.Tensor, mesh, spec: P,
                 grad: str = 'slice') -> torch.Tensor:
    """The global value of the blocks ``x`` that the ranks hold under
    ``spec``: each sharded dim is all-gathered over its axes, the minor
    axis first.  ``grad`` as ``gather``'s."""
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            x = gather(x, mesh, a, d, grad)
    return x


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim: int, grad: str):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        n = dist.get_world_size(group)
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xm, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        n = dist.get_world_size(group)
        gm = g.movedim(dim, 0).contiguous()
        size = gm.shape[0] // n
        if ctx.grad == 'slice':
            i = dist.get_rank(group)
            out = gm[i * size:(i + 1) * size]
        else:
            out = torch.empty((size,) + tuple(gm.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, gm, op=dist.ReduceOp.SUM,
                                       group=group)
        return out.movedim(0, dim), None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int,
           grad: str = 'slice') -> torch.Tensor:
    """All-gather ``x`` over ``axis`` along ``dim`` (rank order).  The
    gradient of this rank's block is its slice of the output's gradient
    (``grad='slice'``: every rank consumes the same value) or that slice
    summed over the axis (``'sum'``: the ranks consume it differently)."""
    if grad not in ('slice', 'sum'):
        raise ValueError(f'unknown gather gradient: {grad!r}')
    return _Gather.apply(x, mesh.get_group(axis), dim, grad)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Split dim 0 of ``x`` into as many chunks as ``axis`` has ranks, send
    chunk ``k`` to rank ``k``, and stack what arrives in rank order."""
    return _AllToAll.apply(x, mesh.get_group(axis))


class _SumGrads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None


def sum_grads(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the ranks of ``axes``
    (each axis's group in turn), where each rank computed its part."""
    return _SumGrads.apply(x, [mesh.get_group(a) for a in axes])


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced with ``op`` over the ranks of ``axes`` (no gradient)."""
    x = x.detach().clone()
    for a in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x
