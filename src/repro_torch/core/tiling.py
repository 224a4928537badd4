"""Tile intersection + depth-sorted per-tile Gaussian lists.

3DGS rasterizes tile-by-tile (16x16 pixels).  This module builds, for every
tile, the depth-sorted list of Gaussians whose screen footprint overlaps it.
Each tile keeps at most ``capacity`` Gaussians (closest-K by depth).

* ``tile_lists_dense``  — O(T*N) overlap matrix + a stable sort: small
  scenes and the test oracle.
* ``tile_lists_sorted`` — the scalable "duplicate + global key sort" path
  (THE Sorting stage of the paper): every Gaussian is duplicated once per
  covered tile (bounded statically), all duplicates are sorted by one int64
  key (tile id in the high 32 bits, the float32 bits of the depth in the
  low 32 — valid depths are positive, and positive floats order like their
  bit patterns), and per-tile slices are recovered with ``searchsorted``.

Ties keep the lower Gaussian index first on both paths, the order the JAX
package's ``lax.top_k`` and two-key ``lax.sort`` give.
"""
from __future__ import annotations

import dataclasses

import torch

from .projection import Projected

TILE = 16  # pixels per tile side (paper's tile size)


@dataclasses.dataclass(frozen=True)
class TileLists:
    """Depth-sorted per-tile lists.

    indices : [T, K] int32 — Gaussian ids sorted near-to-far; -1 padding.
    count   : [T]   int32 — number of valid entries per tile.
    tiles_x, tiles_y : tile-grid dimensions.
    """

    indices: torch.Tensor
    count: torch.Tensor
    tiles_x: int
    tiles_y: int


@dataclasses.dataclass(frozen=True)
class TileFeatures:
    """Per-tile gathered screen-space features (fixed [T, K, ...])."""

    mean2d: torch.Tensor   # [T, K, 2]
    conic: torch.Tensor    # [T, K, 3]
    color: torch.Tensor    # [T, K, 3]
    opacity: torch.Tensor  # [T, K]
    ids: torch.Tensor      # [T, K] int32 global Gaussian ids (-1 pad)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _tile_bounds(tiles_x: int, tiles_y: int, device):
    """Pixel-space bounds of each tile: [T] tensors x0,y0,x1,y1."""
    t = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=device)
    x0 = ((t % tiles_x) * TILE).float()
    y0 = ((t // tiles_x) * TILE).float()
    return x0, y0, x0 + TILE, y0 + TILE


def tile_lists_dense(proj: Projected, width: int, height: int,
                     capacity: int) -> TileLists:
    """Exact per-tile lists via a dense [T, N] overlap test (small scenes)."""
    tiles_x, tiles_y = tile_grid(width, height)
    x0, y0, x1, y1 = _tile_bounds(tiles_x, tiles_y, proj.depth.device)
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    overlap = ((mx[None, :] + r[None, :] >= x0[:, None])
               & (mx[None, :] - r[None, :] < x1[:, None])
               & (my[None, :] + r[None, :] >= y0[:, None])
               & (my[None, :] - r[None, :] < y1[:, None])
               & proj.valid[None, :] & (r[None, :] > 0))          # [T, N]
    key = torch.where(overlap, proj.depth[None, :],
                      torch.full_like(overlap, float('inf'), dtype=torch.float32))
    k = min(capacity, key.shape[1])
    # stable ascending sort: equal depths keep the lower index first
    top, idx = torch.sort(key, dim=1, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    got = torch.isfinite(top)
    idx = torch.where(got, idx, -1).to(torch.int32)
    if k < capacity:  # pad to requested capacity
        pad = capacity - k
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        got = torch.nn.functional.pad(got, (0, pad), value=False)
    count = got.sum(dim=1).to(torch.int32)
    return TileLists(idx, count, tiles_x, tiles_y)


def tile_lists_sorted(proj: Projected, width: int, height: int,
                      capacity: int, max_tiles_per_gaussian: int = 16) -> TileLists:
    """Scalable per-tile lists: duplicate Gaussians per covered tile and run
    one global (tile, depth) sort.  ``max_tiles_per_gaussian`` must be a
    perfect square (d x d tile window anchored at the bbox min)."""
    d = int(round(max_tiles_per_gaussian ** 0.5))
    assert d * d == max_tiles_per_gaussian, 'max_tiles_per_gaussian must be square'
    tiles_x, tiles_y = tile_grid(width, height)
    dev = proj.depth.device

    mx, my, r = proj.mean2d[:, 0], proj.mean2d[:, 1], proj.radius
    tx0 = torch.floor((mx - r) / TILE).to(torch.int32)
    ty0 = torch.floor((my - r) / TILE).to(torch.int32)
    tx1 = torch.floor((mx + r) / TILE).to(torch.int32)  # inclusive
    ty1 = torch.floor((my + r) / TILE).to(torch.int32)
    tx0c = torch.clamp(tx0, 0, tiles_x - 1)
    ty0c = torch.clamp(ty0, 0, tiles_y - 1)

    di = torch.arange(d, dtype=torch.int32, device=dev)
    cand_x = tx0c[:, None] + di[None, :]                       # [N, d]
    cand_y = ty0c[:, None] + di[None, :]
    # cand >= tx0 (UNCLIPPED) rejects footprints entirely off-grid
    ok_x = (cand_x >= tx0[:, None]) & (cand_x <= tx1[:, None]) & (cand_x < tiles_x)
    ok_y = (cand_y >= ty0[:, None]) & (cand_y <= ty1[:, None]) & (cand_y < tiles_y)

    tile_id = (cand_y[:, :, None] * tiles_x + cand_x[:, None, :]).reshape(-1)
    ok = (ok_y[:, :, None] & ok_x[:, None, :]).reshape(-1)
    ok = ok & torch.repeat_interleave(proj.valid & (proj.radius > 0), d * d)

    num_tiles = tiles_x * tiles_y
    tile_key = torch.where(ok, tile_id, num_tiles).to(torch.int64)  # invalid -> sentinel
    depth = torch.where(ok, torch.repeat_interleave(proj.depth, d * d),
                        float('inf'))
    depth_bits = depth.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (tile_key << 32) | depth_bits
    key_sorted, order = torch.sort(key, stable=True)
    idx_sorted = (order // (d * d)).to(torch.int32)           # Gaussian id
    tile_sorted = key_sorted >> 32

    tids = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    start = torch.searchsorted(tile_sorted, tids, side='left')
    end = torch.searchsorted(tile_sorted, tids, side='right')
    count = torch.clamp(end - start, max=capacity).to(torch.int32)

    offs = torch.arange(capacity, dtype=torch.int64, device=dev)
    pos = torch.clamp(start[:, None] + offs[None, :], 0, key.shape[0] - 1)
    in_range = offs[None, :] < (end - start)[:, None]
    indices = torch.where(in_range, idx_sorted[pos], -1).to(torch.int32)
    return TileLists(indices, count, tiles_x, tiles_y)


class _TakeRows(torch.autograd.Function):
    """``table[safe]`` for [T, K] ids ``idx`` whose -1 padding reads row 0
    (``safe``).  The forward is that indexing.  The backward accumulates
    into the rows the valid ids name, and the padding carries no gradient:
    its slots are spread over distinct rows with zero gradients.  Plain
    autograd would pile every padding slot onto row 0, and its sort-based
    accumulation walks a run of equal indices one by one: at 1920x1080 with
    lists of 1024, that took seconds a step."""

    @staticmethod
    def forward(ctx, table, idx, safe):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[safe]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        pad = idx < 0
        spread = torch.arange(idx.numel(), device=idx.device).view(idx.shape)
        rows = torch.where(pad, spread % ctx.rows, idx.long())
        zero = pad.view(*pad.shape, *([1] * (grad.ndim - pad.ndim)))
        out = grad.new_zeros((ctx.rows, *grad.shape[pad.ndim:]))
        out.index_put_((rows,), torch.where(zero, 0.0, grad), accumulate=True)
        return out, None, None


def gather_tile_features(proj: Projected, lists: TileLists) -> TileFeatures:
    """Each tile's list entries' features; padding reads Gaussian 0 with
    opacity 0.  Differentiable in ``proj`` (``_TakeRows``)."""
    idx = lists.indices
    safe = torch.clamp(idx, min=0).long()

    def take(x):
        return _TakeRows.apply(x, idx, safe)

    return TileFeatures(
        mean2d=take(proj.mean2d),
        conic=take(proj.conic),
        color=take(proj.color),
        opacity=torch.where(idx < 0, 0.0, take(proj.opacity)),
        ids=idx,
    )
