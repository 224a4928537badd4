"""Pipeline parallelism (GPipe) over the 'pod' axis, as the JAX package's
``runtime.pipeline``.

``recipe="pp"`` places half the layers on each pod: activations cross pods
once per microbatch in each direction (point to point) and the gradient
all-reduce never leaves a pod.

Classic GPipe for 2 stages: each rank holds its stage's layer stack (by
its ``pod`` coordinate), the microbatches run in a loop of
``n_microbatches + 1`` ticks, and after every tick the boundary
activations move one stage on, as one ``batch_isend_irecv`` pair (the JAX
package's ``ppermute``).  A rank with no work in a tick sends zeros, as
the JAX package's masked SPMD bubble does, without computing them.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import tree as tree_util
from .sharding import mesh_axes
from .spmd import coord


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def split_stage_params(params_blocks, n_stages: int, stage_axis: int = 0):
    """Split a layer-stacked param tree [L, ...] into [n_stages, L/s, ...]."""
    def split(x):
        n = x.shape[stage_axis]
        if n % n_stages:
            raise ValueError(f'{n} layers do not split into {n_stages} stages')
        return x.reshape((n_stages, n // n_stages) + tuple(x.shape[1:]))
    return tree_util.rebuild(params_blocks, _is_tensor, split)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """What the rank ``shift`` places before this one along ``axis`` sent
    (each rank sends ``x`` to the rank ``shift`` places after it)."""
    n = mesh_axes(mesh)[axis]
    dim = mesh.mesh_dim_names.index(axis)
    here = mesh.get_coordinate()

    def rank_at(c: int) -> int:
        at = list(here)
        at[dim] = c % n
        return int(mesh.mesh[tuple(at)])

    c = here[dim]
    out = torch.empty_like(x)
    group = mesh.get_group(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), rank_at(c + shift), group),
        dist.P2POp(dist.irecv, out, rank_at(c - shift), group)])
    for r in reqs:
        r.wait()
    return out


def gpipe_forward(block_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                  n_microbatches: int, axis: str = 'pod') -> torch.Tensor:
    """Run ``x`` [B, S, D] through 2 pipeline stages over ``axis``.

    ``block_fn(params_stack, x) -> x`` applies one stage's layer stack.
    ``stage_params`` has a leading [2, ...] stage axis; this rank takes its
    stage's slice.  Returns the final activations, the same on every rank
    after the closing exchange.
    """
    n_stages = mesh_axes(mesh)[axis]
    if n_stages != 2:
        raise ValueError(f'the GPipe schedule is written for 2 stages, the '
                         f'{axis!r} axis has {n_stages}')
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f'batch {b} is not a multiple of {n_microbatches} '
                         'microbatches')
    mb = b // n_microbatches
    stage = coord(mesh, axis)
    p_stage = tree_util.rebuild(stage_params, _is_tensor, lambda a: a[stage])

    micro = [x[i * mb:(i + 1) * mb] for i in range(n_microbatches)]
    zeros = torch.zeros_like(micro[0])
    inflight = zeros
    outputs = []
    # stage s works on microbatch t - s at tick t
    for t in range(n_microbatches + n_stages - 1):
        if stage == 0:
            has_work = t < n_microbatches
            stage_in = micro[t] if has_work else zeros
        else:
            has_work, stage_in = 0 < t <= n_microbatches, inflight
        out = block_fn(p_stage, stage_in) if has_work else zeros
        # stage 0 -> stage 1 handoff (stage 1's finished microbatch wraps
        # to stage 0, which ignores it)
        inflight = ppermute(out, mesh, axis)
        if 0 < t <= n_microbatches:
            outputs.append(out)       # stage 1's completed microbatch
    y = torch.cat(outputs, dim=0)
    # the last stage's activations to every pod
    y_last = ppermute(y, mesh, axis)
    return y_last if stage == 0 else y
