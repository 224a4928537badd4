"""S^2 — the Sorting-Shared algorithm (paper Sec. 3.1).

Two concurrent paths:
  * **speculative sorting** — predict the camera pose at the center of the
    next sharing window (constant-velocity extrapolation, Eqns. 2-3), run
    Projection + Sorting there once, with an *expanded viewport* so every
    rendered frustum in the window is covered;
  * **sorting-shared rendering** — each rendered frame reuses the speculative
    tile lists / depth order, refreshing only the per-Gaussian screen-space
    arithmetic (and the SH colors) at its own pose, then rasterizes.

The camera frustum grows by ``margin`` px per side (rounded up to whole
tiles so the expanded tile grid embeds the render grid), and every tile's
gather footprint is inflated by ``margin`` px.
"""
from __future__ import annotations

import dataclasses

import torch

from .camera import Camera, expand_viewport, slerp
from .gaussians import GaussianScene
from .projection import Projected, project, reproject_geometry
from .sorting import sort_scene
from .tiling import TILE, TileLists, gather_tile_features, tile_grid


@dataclasses.dataclass(frozen=True)
class SortShared:
    """Speculative sorting result shared across one window."""

    proj: Projected       # projection at the (expanded) sorting pose
    lists: TileLists      # tile lists on the expanded grid
    margin_tiles: int
    render_tiles_x: int
    render_tiles_y: int


def predict_pose(prev: Camera, cur: Camera, window: int) -> Camera:
    """Predict the pose at the center of the next sharing window:
    v = (F_j - F_{j-1}) / dt;  S_k = F_j + v * (window/2) * dt  (Eqns. 2-3).
    Rotation is extrapolated with slerp at the same horizon."""
    t = 1.0 + window / 2.0   # extrapolation factor from `prev` through `cur`
    position = prev.position + t * (cur.position - prev.position)
    return cur.replace(position=position, quat=slerp(prev.quat, cur.quat, t))


def predict_window_pose(prev: Camera, cur: Camera, frame_idx: int,
                        window: int) -> Camera:
    """``predict_pose`` with the cold-start guard: frame 0 has no real
    previous pose, so prediction starts from ``cur`` itself."""
    return predict_pose(cur if frame_idx == 0 else prev, cur, window)


def speculative_sort(scene: GaussianScene, pred_cam: Camera, *,
                     margin: int, capacity: int, method: str = 'dense',
                     max_tiles_per_gaussian: int = 16) -> SortShared:
    """Projection + Sorting at the predicted pose with the expanded viewport."""
    rtx = (pred_cam.width + TILE - 1) // TILE
    rty = (pred_cam.height + TILE - 1) // TILE
    margin_tiles = -(-margin // TILE) if margin > 0 else 0  # ceil to whole tiles
    cam_exp = expand_viewport(pred_cam, margin_tiles * TILE)
    proj = project(scene, cam_exp)
    lists = sort_scene(proj, cam_exp.width, cam_exp.height, capacity,
                       method=method, radius_margin=float(margin),
                       max_tiles_per_gaussian=max_tiles_per_gaussian)
    return SortShared(proj=proj, lists=lists, margin_tiles=margin_tiles,
                      render_tiles_x=rtx, render_tiles_y=rty)


def empty_sort_shared(scene: GaussianScene, cam: Camera, *, margin: int,
                      capacity: int) -> SortShared:
    """A zero-filled ``SortShared`` with the structure ``speculative_sort``
    gives for (scene, cam): what a serving pool entry holds before its
    first sort.  Its projection is invalid, so the prep of a lane that
    rides it (an idle lane of an active scene) yields zero-opacity
    features, as the JAX package's zero-filled entry does."""
    rtx, rty = tile_grid(cam.width, cam.height)
    margin_tiles = -(-margin // TILE) if margin > 0 else 0
    tx, ty = tile_grid(cam.width + 2 * margin_tiles * TILE,
                       cam.height + 2 * margin_tiles * TILE)
    n, dev = scene.means.shape[0], scene.means.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    proj = Projected(mean2d=zeros(n, 2), conic=zeros(n, 3), radius=zeros(n),
                     depth=zeros(n), color=zeros(n, 3), opacity=zeros(n),
                     valid=zeros(n, dtype=torch.bool))
    lists = TileLists(zeros(tx * ty, capacity, dtype=torch.int32),
                      zeros(tx * ty, dtype=torch.int32), tx, ty)
    return SortShared(proj=proj, lists=lists, margin_tiles=margin_tiles,
                      render_tiles_x=rtx, render_tiles_y=rty)


def _render_sublists(shared: SortShared) -> TileLists:
    """Extract the render-grid tile lists out of the expanded grid."""
    mt = shared.margin_tiles
    lists = shared.lists
    k = lists.indices.shape[1]
    rtx, rty = shared.render_tiles_x, shared.render_tiles_y
    grid = lists.indices.reshape(lists.tiles_y, lists.tiles_x, k)
    cnt = lists.count.reshape(lists.tiles_y, lists.tiles_x)
    sub = grid[mt:mt + rty, mt:mt + rtx]
    sub_cnt = cnt[mt:mt + rty, mt:mt + rtx]
    return TileLists(sub.reshape(rtx * rty, k), sub_cnt.reshape(rtx * rty),
                     rtx, rty)


def shared_features(scene: GaussianScene, cam: Camera, shared: SortShared):
    """Sorting-shared per-frame prep: refresh screen-space geometry + SH
    colors at the *render* pose, reuse the speculative tile lists / depth
    order.  Returns (TileFeatures on the render grid, render TileLists)."""
    proj_now = reproject_geometry(scene, cam, shared.proj)
    lists = _render_sublists(shared)
    return gather_tile_features(proj_now, lists), lists
