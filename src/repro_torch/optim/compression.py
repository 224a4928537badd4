"""Int8 block-quantized gradient compression with error feedback, as the
JAX package's ``optim.compression``.

A tensor is flattened in float32, padded to whole blocks of ``BLOCK``
elements, and each block is stored as int8 ``round(x / scale)`` with
``scale = max|block| / 127`` (at least 1e-12); ``torch.round`` rounds half
to even, as ``jnp.round`` does.  With error feedback, the residual of the
last quantization is added before the next one, so the time average of
what is sent converges to the true gradient.

A tree is a dict, list or tuple of tensors (nested), walked in
``repro_torch.tree``'s order, as the checkpoint manager walks it; a
``Compressed`` is one leaf.  ``psum_compressed`` sums the int8 payloads
across the ranks of a process group (a mesh axis's group,
``mesh.get_group('data')``) after a max-scale requantization, as the JAX
package's does inside ``shard_map``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import tree as tree_util

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload [blocks, BLOCK]
    scale: torch.Tensor    # float32 per-block scales [blocks]
    shape: tuple           # the original shape


def compress(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Block-quantize one tensor to int8.  Returns (Compressed, the new
    residual: float32, ``x``'s shape)."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    if residual is not None:
        flat = flat + residual.reshape(-1)
    n = flat.numel()
    padded = torch.zeros(-(-n // BLOCK) * BLOCK, dtype=torch.float32,
                         device=x.device)
    padded[:n] = flat
    blocks = padded.reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(
        torch.int8)
    deq = q.float() * scale[:, None]
    new_residual = (blocks - deq).reshape(-1)[:n].reshape(shape)
    return Compressed(q, scale, shape), new_residual


def decompress(c: Compressed) -> torch.Tensor:
    deq = c.q.float() * c.scale[:, None]
    n = 1
    for d in c.shape:
        n *= d
    return deq.reshape(-1)[:n].reshape(c.shape)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Compressed))


def _leaves(tree: Any) -> list:
    return tree_util.leaves(tree, _is_leaf)


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves taken in ``_leaves`` order from the
    iterator ``leaves``."""
    return tree_util.rebuild(tree, _is_leaf, lambda _: next(leaves))


def compress_tree(tree: Any, residuals: Any = None):
    """``compress`` every leaf, with the residual at the same place of
    ``residuals`` where given.  Returns (tree of Compressed, tree of new
    residuals)."""
    xs = _leaves(tree)
    rs = _leaves(residuals) if residuals is not None else [None] * len(xs)
    outs = [compress(x, r) for x, r in zip(xs, rs, strict=True)]
    return (_unflatten(tree, (o[0] for o in outs)),
            _unflatten(tree, (o[1] for o in outs)))


def decompress_tree(comp: Any) -> Any:
    return _unflatten(comp, (decompress(c) for c in _leaves(comp)))


def init_residuals(tree: Any) -> Any:
    return _unflatten(tree, (torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device)
                             for x in _leaves(tree)))


def psum_compressed(grads: Any, residuals: Any, group):
    """Error-feedback int8 all-reduce of ``grads`` over the ranks of
    ``group``.  Returns (the summed tree, float32, ``grads``' shapes; the
    tree of new residuals).

    The blocks of every rank are requantized to the largest scale of the
    group (``all_reduce`` MAX), rounded half to even as ``jnp.round``
    rounds, and summed in int32, which is exact."""
    comp, new_res = compress_tree(grads, residuals)

    def reduce_one(c: Compressed) -> torch.Tensor:
        smax = c.scale.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        ratio = c.scale / smax
        total = torch.round(c.q.float() * ratio[:, None]).to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return decompress(Compressed(total, smax, c.shape))

    return (_unflatten(comp, (reduce_one(c) for c in _leaves(comp))),
            new_res)
