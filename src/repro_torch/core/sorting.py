"""Sorting stage wrapper: the interface the pipeline consumes, and the
order-agreement diagnostic behind the paper's claim that only ~0.2 % of
depth-order pairs flip between adjacent poses (Sec. 3.1).  The actual
(tile, depth) sort lives in ``repro_torch.core.tiling``."""
from __future__ import annotations

import torch

from .projection import Projected
from .tiling import TileLists, tile_lists_dense, tile_lists_sorted


def sort_scene(proj: Projected, width: int, height: int, capacity: int,
               method: str = 'dense', radius_margin: float = 0.0,
               max_tiles_per_gaussian: int = 16) -> TileLists:
    """Build depth-sorted per-tile lists.

    ``radius_margin`` inflates each Gaussian's footprint by that many pixels
    — the per-tile half of the S^2 expanded viewport: a Gaussian within
    ``margin`` px of a tile is included in that tile's list so small camera
    motion within the sharing window cannot move it out of coverage.
    """
    if radius_margin:
        proj = proj.replace(radius=torch.where(
            proj.valid, proj.radius + radius_margin, proj.radius))
    if method == 'dense':
        return tile_lists_dense(proj, width, height, capacity)
    if method == 'sorted':
        return tile_lists_sorted(proj, width, height, capacity,
                                 max_tiles_per_gaussian=max_tiles_per_gaussian)
    raise ValueError(f'unknown sorting method: {method}')


def pairwise_order_agreement(lists_a: TileLists,
                             lists_b: TileLists) -> torch.Tensor:
    """Fraction of adjacent-pair depth orderings preserved between two sorts.

    For each tile, the relative order of consecutive entries of ``lists_a``
    is compared as they appear in ``lists_b`` (the first position of each
    id there).  Entries missing from ``lists_b`` are ignored.  Returns a
    float32 scalar in [0, 1]; the paper reports ~99.8 % for adjacent VR
    poses.  All tiles at once: each row of ``lists_b`` is sorted once
    (stably, so equal ids keep their first position) and searched.
    """
    a = lists_a.indices.long()                          # [T, K]
    b = lists_b.indices.long()
    b_sorted, order = torch.sort(b, dim=1, stable=True)
    at = torch.searchsorted(b_sorted, a).clamp(max=b.shape[1] - 1)
    present = (torch.gather(b_sorted, 1, at) == a) & (a >= 0)
    pos = torch.where(present, torch.gather(order, 1, at), -1)
    p0, p1 = pos[:, :-1], pos[:, 1:]
    both = (p0 >= 0) & (p1 >= 0)
    kept = ((p1 > p0) & both).sum()
    return kept / torch.clamp(both.sum(), min=1)
