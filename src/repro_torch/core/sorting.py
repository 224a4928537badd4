"""Sorting stage wrapper: the interface the pipeline consumes.  The actual
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
