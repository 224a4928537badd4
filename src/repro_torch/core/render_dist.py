"""Distributed LuminSys: the paper's own workload on a device mesh, as the
JAX package's ``core.render_dist``.

  * Gaussians shard over the batch axes (pod x data): projection, SH color
    and culling are independent per Gaussian.
  * Tiles shard over ``model`` (and the batch axes where the tile count
    allows): rasterization is independent per tile.
  * Between the two sits the sort, run on every rank over the gathered
    projection.

The JAX package lets GSPMD place these; the port writes the frame as
explicit SPMD (``runtime.spmd``): each rank projects its rows of
Gaussians, all-gathers the projection, sorts, rasterizes its block of
tiles and all-gathers the colors and significance counts.  Since both
stages are independent per row and per tile, the frame equals the
mesh-free frame bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..runtime import spmd
from ..runtime.sharding import P, adaptive_spec, batch_axes, entry_axes
from .camera import Camera, make_camera
from .gaussians import FIELDS, GaussianScene
from .pipeline import LuminaConfig
from .projection import Projected, project
from .rasterize import rasterize_tiles
from .sorting import sort_scene
from .tiling import TILE, TileLists, gather_tile_features, tile_grid

RENDER_SHAPE_TABLE = {
    # name: (num_gaussians, width, height, capacity)
    'render_1080p': (1_048_576, 1920, 1088, 512),
    'render_720p': (1_048_576, 1280, 720, 512),
}

# the scene's [N, ...] fields and their trailing shapes
_SCENE_SHAPES = {'means': (3,), 'log_scales': (3,), 'quats': (4,),
                 'opacity_logit': (), 'sh_dc': (3,), 'sh_rest': (3, 3)}


def scene_specs(mesh, n: int):
    """The rule placing a Gaussian array: rows over pod x data."""
    baxes = batch_axes(mesh)

    def rule(leaf):
        return adaptive_spec(leaf.shape, mesh, [(0, baxes)])
    return rule


def abstract_scene(n: int) -> GaussianScene:
    """A scene of ``n`` Gaussians on the ``meta`` device (no storage)."""
    return GaussianScene(*(torch.empty((n,) + _SCENE_SHAPES[f],
                                       dtype=torch.float32, device='meta')
                           for f in FIELDS))


def _tile_spec(mesh, num_tiles: int) -> P:
    """Tiles over model x pod x data where their count allows, else over
    ``model`` (at 1080p, 8160 tiles are not divisible by 256)."""
    taxes = ('model',) + batch_axes(mesh)
    return adaptive_spec((num_tiles,), mesh, [(0, taxes), (0, 'model')])


def _gather_projected(proj: Projected, mesh, spec: P) -> Projected:
    """Every rank's rows of ``proj``, all-gathered in row order."""
    def full(x):
        if x.dtype == torch.bool:
            return spmd.gather_block(x.to(torch.uint8), mesh, spec).bool()
        return spmd.gather_block(x, mesh, spec)
    return Projected(*(full(getattr(proj, f.name))
                       for f in dataclasses.fields(Projected)))


@torch.no_grad()
def _serve_frame(scene: GaussianScene, cam: Camera, mesh, cfg: LuminaConfig):
    """One sorting-shared frame on this rank of ``mesh`` (or alone, with no
    mesh).  Returns (tile colors [T, P, 3], n_significant [T, P]), the
    same on every rank."""
    if mesh is None:
        proj = project(scene, cam)
    else:
        gspec = scene_specs(mesh, scene.num_gaussians)(scene.means)
        local = GaussianScene(*(spmd.local_block(getattr(scene, f), mesh,
                                                 gspec) for f in FIELDS))
        proj = _gather_projected(project(local, cam), mesh, gspec)
    lists = sort_scene(proj, cam.width, cam.height, cfg.capacity,
                       method=cfg.sort_method,
                       max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
    num_tiles = lists.indices.shape[0]
    tspec = P() if mesh is None else _tile_spec(mesh, num_tiles)
    first = 0
    if tspec:
        i, n = spmd.block(mesh, entry_axes(tspec[0]))
        first = i * (num_tiles // n)
        lists = TileLists(spmd.local_block(lists.indices, mesh, tspec),
                          spmd.local_block(lists.count, mesh, tspec),
                          lists.tiles_x, lists.tiles_y)
    feats = gather_tile_features(proj, lists)
    colors, aux = rasterize_tiles(feats, lists.tiles_x, k_record=cfg.k_record,
                                  bg=cfg.bg, first_tile=first)
    nsig = aux.n_significant
    if tspec:
        colors = spmd.gather_block(colors, mesh, tspec)
        nsig = spmd.gather_block(nsig, mesh, tspec)
    return colors, nsig


def build_dryrun_cell(arch_cfg, mesh, shape_name: str):
    """(serve step, meta-device arguments, model FLOPs) of the render
    dry-run cell ``shape_name``.  The step renders one frame of its scene
    on this rank and returns (tile colors, the significance count)."""
    n, w, h, cap = RENDER_SHAPE_TABLE[shape_name]
    lcfg = LuminaConfig(capacity=cap, window=arch_cfg.window,
                        margin=arch_cfg.margin, k_record=arch_cfg.k_record,
                        sort_method='sorted')

    def serve_step(scene: GaussianScene):
        cam = make_camera((0.0, 0.0, 2.5), (1.0, 0.0, 0.0, 0.0), 60.0, w, h,
                          device=scene.device)
        colors, nsig = _serve_frame(scene, cam, mesh, lcfg)
        return colors, nsig.sum()

    # MODEL_FLOPS for rendering: alpha-eval + blend per (pixel, listed
    # gaussian): ~30 flops for the conic/exp frontend + 8 for integration.
    tx, ty = tile_grid(w, h)
    mf = tx * ty * cap * (TILE * TILE) * 38.0
    return serve_step, (abstract_scene(n),), mf
