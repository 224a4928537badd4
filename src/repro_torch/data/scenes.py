"""Procedural Gaussian scenes and the streaming chunk container.

``structured_scene`` builds a spatially coherent scene — Gaussians laid on
parametric surfaces (sphere / plane / torus) with smooth color fields — so
the temporal and ray-coherence properties Lumina exploits hold, as they do
for trained scenes.  Random numbers come from an explicit
``torch.Generator``; the streams differ from the JAX package's, so the two
packages give different scenes for one seed (tests hand the JAX scene over
through ``repro_torch.interop``).

``partition_scene`` turns a scene into a ``ChunkedScene``: the Gaussians
grouped into spatial-cell-indexed chunks (the ``floor(p / cell_size)``
quantization ``core/posecell.py`` applies to camera positions), each chunk
padded to a fixed ``chunk_cap`` lanes with neutral Gaussians (means far
outside the frustum: ``project`` culls them, so a neutral lane contributes
nothing, even through a stale sorted tile list).  Within a chunk the
Gaussians are ordered by descending significance, so a prefix of the chunk
is its LOD subset: ``level_rows`` maps a residency level to the row count,
and ``masked_scene`` neutralizes every lane past the per-chunk budget.  The
residency manager (``repro_torch.serve.streaming``) pages these
fixed-shape chunks through a device arena.  The partition lives on the host
(numpy); the mask is built on the arena's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.gaussians import FIELDS, SH_C0, GaussianScene
from ..device import resolve_device


def _normal(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev)


def _uniform(gen, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def _sphere(gen, n, center, radius, base_color, dev):
    d = _normal(gen, (n, 3), dev)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9)
    means = torch.tensor(center, device=dev) + radius * d
    return means, torch.tensor(base_color, device=dev) + 0.35 * d


def _plane(gen, n, origin, u, v, base_color, dev):
    ab = _uniform(gen, (n, 2), -1.0, 1.0, dev)
    means = (torch.tensor(origin, device=dev) + ab[:, :1] * torch.tensor(u, device=dev)
             + ab[:, 1:2] * torch.tensor(v, device=dev))
    col = torch.tensor(base_color, device=dev) + 0.25 * torch.cat(
        [torch.sin(3 * ab), torch.cos(2 * ab[:, :1] + ab[:, 1:2])], dim=-1)
    return means, col


def _torus(gen, n, center, r_major, r_minor, base_color, dev):
    th = _uniform(gen, (n,), 0.0, 2 * math.pi, dev)
    ph = _uniform(gen, (n,), 0.0, 2 * math.pi, dev)
    x = (r_major + r_minor * torch.cos(ph)) * torch.cos(th)
    y = r_minor * torch.sin(ph)
    z = (r_major + r_minor * torch.cos(ph)) * torch.sin(th)
    means = torch.tensor(center, device=dev) + torch.stack([x, y, z], dim=-1)
    col = torch.tensor(base_color, device=dev) + 0.3 * torch.stack(
        [torch.cos(th), torch.sin(2 * ph), torch.sin(th + ph)], dim=-1)
    return means, col


def structured_scene(generator: torch.Generator | int, num_gaussians: int,
                     scale_range=(0.015, 0.06), large_gaussian_frac: float = 0.0,
                     *, device=None) -> GaussianScene:
    """A coherent multi-surface scene in the unit-ish cube around the origin.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one.  ``device`` defaults to the card.  ``large_gaussian_frac`` injects
    a fraction of oversized Gaussians (all three scales 0.35) to recreate
    the failure mode cache-aware fine-tuning fixes (Fig. 13).  That draw
    comes after every other, and only when the fraction is above 0, so the
    default stream, and the scene of every seed, stay as they were.
    """
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    n1 = num_gaussians // 3
    n2 = num_gaussians // 3
    n3 = num_gaussians - n1 - n2
    m1, c1 = _sphere(generator, n1, (0.0, 0.1, 0.0), 0.45, (0.7, 0.3, 0.25), dev)
    m2, c2 = _plane(generator, n2, (0.0, -0.5, 0.0), (1.2, 0.0, 0.0),
                    (0.0, 0.0, 1.2), (0.25, 0.55, 0.3), dev)
    m3, c3 = _torus(generator, n3, (0.0, 0.35, 0.0), 0.7, 0.12,
                    (0.3, 0.35, 0.75), dev)
    means = torch.cat([m1, m2, m3])
    colors = torch.clamp(torch.cat([c1, c2, c3]), 0.02, 0.98)

    n = num_gaussians
    log_scales = torch.log(_uniform(generator, (n, 3), scale_range[0],
                                    scale_range[1], dev))
    quats = _normal(generator, (n, 4), dev)
    quats[:, 0] += 3.0
    opacity_logit = _uniform(generator, (n,), 0.5, 3.0, dev)
    # invert the SH DC activation: c = SH_C0 * dc + 0.5  =>  dc = (c - 0.5)/SH_C0
    sh_dc = (colors - 0.5) / SH_C0
    sh_rest = 0.08 * _normal(generator, (n, 3, 3), dev)
    if large_gaussian_frac > 0:
        big = torch.rand((n, 1), generator=generator, device=dev) < large_gaussian_frac
        log_scales = torch.where(big, math.log(0.35), log_scales)
    return GaussianScene(means, log_scales, quats, opacity_logit, sh_dc, sh_rest)


# -- streaming chunk container ------------------------------------------------

# one Gaussian = 23 float32 fields (means 3 + log_scales 3 + quats 4 +
# opacity_logit 1 + sh_dc 3 + sh_rest 9)
BYTES_PER_GAUSSIAN = 92

# a neutral lane: far outside any frustum (``project`` culls depth > far),
# identity rotation, opacity ~ 0 even unculled
_NEUTRAL_MEAN = 1.0e6
_NEUTRAL_OPACITY_LOGIT = -30.0

# residency levels, low to high: absent -> coarse LOD prefix -> full chunk
LEVEL_ABSENT, LEVEL_LOD, LEVEL_FULL = 0, 1, 2


class SceneArrays(NamedTuple):
    """A scene's six raw fields as plain arrays: numpy on the host side of
    the streaming path, tensors in the device arena (``GaussianScene``'s
    field order and shapes)."""

    means: Any
    log_scales: Any
    quats: Any
    opacity_logit: Any
    sh_dc: Any
    sh_rest: Any


def _host_arrays(scene) -> SceneArrays:
    """A ``GaussianScene`` (or ``SceneArrays``) as numpy ``SceneArrays``."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return SceneArrays(*(host(getattr(scene, f)) for f in FIELDS))


def neutral_scene(n: int) -> SceneArrays:
    """``n`` neutral lanes (host arrays): culled by every frustum, zero
    contribution."""
    return SceneArrays(
        means=np.full((n, 3), _NEUTRAL_MEAN, np.float32),
        log_scales=np.zeros((n, 3), np.float32),
        quats=np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        opacity_logit=np.full((n,), _NEUTRAL_OPACITY_LOGIT, np.float32),
        sh_dc=np.zeros((n, 3), np.float32),
        sh_rest=np.zeros((n, 3, 3), np.float32))


def scene_nbytes(scene_or_count) -> int:
    """Payload bytes of a scene (or a Gaussian count)."""
    n = (scene_or_count if isinstance(scene_or_count, int)
         else int(scene_or_count.means.shape[0]))
    return n * BYTES_PER_GAUSSIAN


@dataclasses.dataclass(frozen=True)
class ChunkedScene:
    """A scene partitioned into fixed-capacity, cell-indexed chunks.

    ``packed`` is host-side (numpy ``SceneArrays``): the "disk" side of the
    streaming path.  Chunk ``i`` occupies rows ``[i*chunk_cap,
    (i+1)*chunk_cap)``, its first ``fill[i]`` rows real Gaussians in
    descending significance, the rest neutral padding.  ``cells[i]`` is the
    chunk's integer grid cell (``floor(mean / cell_size)``, which every
    Gaussian of the chunk shares).
    """

    packed: SceneArrays          # [num_chunks * chunk_cap] host arrays
    cells: np.ndarray            # [num_chunks, 3] int64 grid cell per chunk
    fill: np.ndarray             # [num_chunks] int64 real rows per chunk
    cell_size: float
    chunk_cap: int
    source_count: int            # Gaussians in the source scene

    @property
    def num_chunks(self) -> int:
        return int(self.fill.shape[0])

    @property
    def scene_bytes(self) -> int:
        """Full-scene payload bytes (what a fully resident run holds)."""
        return scene_nbytes(self.source_count)

    def chunk_block(self, chunk: int, rows: int,
                    keep: int | None = None) -> SceneArrays:
        """Host copy of one chunk's first ``rows`` lanes with only the first
        ``keep`` real (default: the chunk's fill).  Lanes past ``keep`` are
        neutral, so an arena write of the block leaves no stale lanes behind
        an LOD prefix."""
        lo = chunk * self.chunk_cap
        keep = int(self.fill[chunk]) if keep is None else int(keep)
        keep = min(rows, keep, int(self.fill[chunk]))
        pad = neutral_scene(rows - keep)
        return SceneArrays(*(np.concatenate([x[lo:lo + keep], p])
                             for x, p in zip(self.packed, pad)))

    def meta_dict(self) -> dict:
        """JSON-able partition geometry (a checkpoint manifest carries it so
        that a restore can check it resumes onto the same partition)."""
        return {'num_chunks': self.num_chunks,
                'chunk_cap': int(self.chunk_cap),
                'cell_size': float(self.cell_size),
                'source_count': int(self.source_count),
                'fill': [int(f) for f in self.fill]}


def partition_scene(scene, cell_size: float = 0.4,
                    chunk_cap: int = 64) -> ChunkedScene:
    """Deterministically partition a scene into cell-indexed chunks.

    Gaussians are bucketed by grid cell (``floor(mean / cell_size)``, the
    position quantization ``core/posecell.py`` applies to camera poses),
    each cell's population ordered by descending significance
    (``sigmoid(opacity) * exp(mean log-scale)``, ties broken by source
    index) and split into chunks of at most ``chunk_cap``.  Chunk order is
    lexicographic in (cell, within-cell chunk index).  The runs of one cell
    are found from the changes of the sorted cells and every field is
    written with one scatter, so a million Gaussians partition in one pass.
    ``scene`` is a ``GaussianScene`` or host ``SceneArrays``.
    """
    host = _host_arrays(scene)
    n = int(host.means.shape[0])
    cap = int(chunk_cap)
    cells = np.floor(host.means / cell_size).astype(np.int64)
    sig = (1.0 / (1.0 + np.exp(-host.opacity_logit.astype(np.float64)))
           * np.exp(host.log_scales.astype(np.float64).mean(axis=-1)))
    # lexicographic (cell, -significance, index) order groups cells
    # contiguously with each cell's rows significance-descending
    order = np.lexsort((np.arange(n), -sig,
                        cells[:, 2], cells[:, 1], cells[:, 0]))
    sorted_cells = cells[order]
    if n == 0:
        return ChunkedScene(packed=neutral_scene(cap),
                            cells=np.zeros((1, 3), np.int64),
                            fill=np.zeros((1,), np.int64),
                            cell_size=float(cell_size), chunk_cap=cap,
                            source_count=0)
    # runs of equal cells in the sorted order, and their chunks
    starts = np.concatenate(
        [[0], np.flatnonzero((sorted_cells[1:] != sorted_cells[:-1])
                             .any(axis=1)) + 1])
    lengths = np.diff(np.concatenate([starts, [n]]))
    run_chunks = -(-lengths // cap)
    first_chunk = np.concatenate([[0], np.cumsum(run_chunks)[:-1]])
    num_chunks = int(run_chunks.sum())
    # each sorted row's packed lane: its run's first chunk plus its offset
    run_of = np.repeat(np.arange(len(starts)), lengths)
    offset = np.arange(n) - starts[run_of]
    lane = (first_chunk[run_of] + offset // cap) * cap + offset % cap
    packed = neutral_scene(num_chunks * cap)
    for dst, src in zip(packed, host):
        dst[lane] = src[order]
    chunk_run = np.repeat(np.arange(len(starts)), run_chunks)
    within = np.arange(num_chunks) - first_chunk[chunk_run]
    fill = np.minimum(cap, lengths[chunk_run] - within * cap)
    return ChunkedScene(packed=packed, cells=sorted_cells[starts[chunk_run]],
                        fill=fill.astype(np.int64),
                        cell_size=float(cell_size), chunk_cap=cap,
                        source_count=n)


def chunk_levels(chunked: ChunkedScene, cam_positions,
                 near_radius: int, lod_radius: int) -> np.ndarray:
    """Per-chunk residency level for a set of camera positions.

    A chunk's level is the max over cameras of: FULL within ``near_radius``
    grid cells (Chebyshev distance between the chunk's cell and the
    camera's ``floor(pos / cell_size)`` cell), LOD within ``lod_radius``,
    ABSENT beyond.  Pure host math.
    """
    levels = np.zeros((chunked.num_chunks,), np.int64)
    for pos in cam_positions:
        cam_cell = np.floor(np.asarray(pos, np.float64)[:3]
                            / chunked.cell_size).astype(np.int64)
        dist = np.abs(chunked.cells - cam_cell[None, :]).max(axis=1)
        lvl = np.where(dist <= near_radius, LEVEL_FULL,
                       np.where(dist <= lod_radius, LEVEL_LOD, LEVEL_ABSENT))
        levels = np.maximum(levels, lvl)
    return levels


def level_rows(chunked: ChunkedScene, levels: np.ndarray,
               lod_frac: float = 0.5) -> np.ndarray:
    """Rows to hold per chunk at the given residency levels: the full fill
    at FULL, the significance prefix ``ceil(fill * lod_frac)`` at LOD
    (never empty for a non-empty chunk), nothing when absent."""
    fill = chunked.fill
    lod = np.where(fill > 0,
                   np.maximum(np.ceil(fill * lod_frac).astype(np.int64), 1),
                   0)
    return np.where(levels >= LEVEL_FULL, fill,
                    np.where(levels == LEVEL_LOD, lod, 0))


def masked_scene(packed: SceneArrays, rows,
                 chunk_cap: int) -> GaussianScene:
    """Neutralize every lane past its chunk's row budget.

    ``packed`` holds tensors (the device arena); ``rows`` is [num_chunks]
    (a tensor or array): lane ``j`` of chunk ``i`` survives iff ``j <
    rows[i]``.  Surviving lanes keep their exact packed values, so a mask
    covering each chunk's live requirement renders bit-identically to the
    fully resident scene whatever the hidden lanes hold.  Returns a new
    scene on ``packed``'s device.
    """
    means = packed.means
    dev = means.device
    lanes = means.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    lane = torch.arange(lanes, device=dev)
    keep = (lane % chunk_cap) < rows[lane // chunk_cap]

    def mask(x, neutral):
        k = keep.reshape((lanes,) + (1,) * (x.dim() - 1))
        return torch.where(k, x, torch.as_tensor(neutral, dtype=x.dtype,
                                                 device=dev))

    return GaussianScene(
        mask(packed.means, _NEUTRAL_MEAN),
        mask(packed.log_scales, 0.0),
        mask(packed.quats, [1.0, 0.0, 0.0, 0.0]),
        mask(packed.opacity_logit, _NEUTRAL_OPACITY_LOGIT),
        mask(packed.sh_dc, 0.0),
        mask(packed.sh_rest, 0.0))
