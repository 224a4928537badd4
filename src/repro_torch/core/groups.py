"""Pixel <-> cache-tile-group reshaping shared by the reference pipeline and
the kernel path (LuminCache is shared across group_tiles x group_tiles image
tiles; one independent cache state per group)."""
from __future__ import annotations

import torch

from .tiling import tile_grid


def group_dims(tiles_x: int, tiles_y: int, group_tiles: int) -> tuple[int, int, int]:
    gt = group_tiles
    while tiles_x % gt or tiles_y % gt:
        gt -= 1   # fall back to the largest divisor (1 always works)
    return tiles_x // gt, tiles_y // gt, gt


def regroup(x: torch.Tensor, tiles_x: int, tiles_y: int,
            group_tiles: int) -> torch.Tensor:
    """[T, P, ...] tile-major -> [G, B, ...] group-major."""
    gx, gy, gt = group_dims(tiles_x, tiles_y, group_tiles)
    rest = x.shape[2:]
    x = x.reshape(gy, gt, gx, gt, *x.shape[1:])
    x = torch.movedim(x, 2, 1)                  # [gy, gx, gt, gt, P, ...]
    return x.reshape(gy * gx, gt * gt * x.shape[4], *rest)


def ungroup(x: torch.Tensor, tiles_x: int, tiles_y: int,
            group_tiles: int) -> torch.Tensor:
    """[G, B, ...] group-major -> [T, P, ...] tile-major."""
    gx, gy, gt = group_dims(tiles_x, tiles_y, group_tiles)
    p = x.shape[1] // (gt * gt)
    rest = x.shape[2:]
    x = x.reshape(gy, gx, gt, gt, p, *rest)
    x = torch.movedim(x, 1, 2)                  # [gy, gt, gx, gt, P, ...]
    return x.reshape(gy * gx * gt * gt, p, *rest)


def regroup_slots(x: torch.Tensor, tiles_x: int, tiles_y: int,
                  group_tiles: int) -> torch.Tensor:
    """``regroup`` of every slot: [S, T, P, ...] -> [S, G, B, ...]."""
    return torch.stack([regroup(xi, tiles_x, tiles_y, group_tiles) for xi in x])


def ungroup_slots(x: torch.Tensor, tiles_x: int, tiles_y: int,
                  group_tiles: int) -> torch.Tensor:
    """``ungroup`` of every slot: [S, G, B, ...] -> [S, T, P, ...]."""
    return torch.stack([ungroup(xi, tiles_x, tiles_y, group_tiles) for xi in x])


def num_groups(width: int, height: int, group_tiles: int) -> int:
    tx, ty = tile_grid(width, height)
    gx, gy, _ = group_dims(tx, ty, group_tiles)
    return gx * gy
