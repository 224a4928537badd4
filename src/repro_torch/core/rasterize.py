"""Rasterization (color integration) — plain PyTorch reference.

The paper's Eqn. 1 evaluated tile-by-tile in depth order:

    C(p) = sum_i  Gamma_i * alpha_i * c_i,   Gamma_i = prod_{j<i} (1 - alpha_j)

with the two reference-implementation rules Lumina exploits:
  * Gaussians with alpha <= 1/255 are *insignificant* and skipped;
  * integration terminates once Gamma < theta (1e-4).

Besides the image, the rasterizer emits the alpha-record (ids of the first
``k_record`` significant Gaussians of every pixel — the radiance-cache tag
material), per-pixel significant / iterated counts and the iteration index
at which the k-th significant Gaussian was found.

Record semantics differ from the kernel's on purpose: here ``rec_cnt`` is
capped at k, while the kernel (``repro_torch.kernels.rasterize``) counts
every contribution.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .gaussians import ALPHA_MAX, ALPHA_SIGNIFICANT, TRANSMITTANCE_EPS
from .tiling import TILE, TileFeatures

P = TILE * TILE


@dataclasses.dataclass(frozen=True)
class RasterAux:
    """Per-pixel rasterization statistics, shapes [T, P] (P = TILE*TILE)."""

    alpha_record: torch.Tensor   # [T, P, k_record] int32, -1 padded
    n_significant: torch.Tensor  # [T, P] int32
    n_iterated: torch.Tensor     # [T, P] int32 (Gaussians seen before termination)
    iter_at_k: torch.Tensor      # [T, P] int32 (iterations to find k-th significant)
    transmittance: torch.Tensor  # [T, P] final Gamma


def pixel_centers(tiles_x: int, num_tiles: int, device, first_tile: int = 0):
    """Pixel-center coordinates of tiles ``first_tile`` .. ``first_tile +
    num_tiles - 1``: two [T, P] float32 tensors."""
    t = torch.arange(first_tile, first_tile + num_tiles, dtype=torch.int32,
                     device=device)
    p = torch.arange(P, dtype=torch.int32, device=device)
    px = (t % tiles_x * TILE)[:, None] + (p % TILE)[None, :]
    py = (t // tiles_x * TILE)[:, None] + (p // TILE)[None, :]
    return px.float() + 0.5, py.float() + 0.5


def chunk_caps(ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-tile chunk cap: the chunk index one past each tile's last valid
    Gaussian ([T, K] ids -> [T] int32).  Robust to -1 holes mid-list.  The
    reference rasterizer and the kernel wrappers share it, so their chunk
    accounting stays comparable."""
    k = ids.shape[1]
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=ids.device)
    last = torch.where(ids >= 0, pos[None, :], 0).amax(dim=1)
    return ((last + chunk - 1) // chunk).to(torch.int32)


def pad_tile_features(feats: TileFeatures, chunk: int) -> TileFeatures:
    """Pad the per-tile list length K up to a multiple of ``chunk``.
    Padding ids are -1 and opacity 0, so padded iterations touch nothing."""
    k = feats.ids.shape[1]
    pad = (k + chunk - 1) // chunk * chunk - k
    if pad == 0:
        return feats

    def pz(x, fill=0.0):
        widths = [0, 0] * (x.ndim - 2) + [0, pad]
        return torch.nn.functional.pad(x, widths, value=fill)

    return TileFeatures(mean2d=pz(feats.mean2d), conic=pz(feats.conic),
                        color=pz(feats.color), opacity=pz(feats.opacity),
                        ids=pz(feats.ids, -1))


def _walk_step(px, py, live, state, gm, gc, gcol, gop, gid, i: int,
               slots: torch.Tensor):
    """One list position ``i`` for every pixel of the rows given: the
    per-Gaussian arithmetic that the chunked and the dense walk share, op for
    op, so their outputs are bit-identical.  ``gm`` [R, 2], ``gc`` [R, 3],
    ``gcol`` [R, 3], ``gop`` and ``gid`` [R, 1]; ``state`` is (acc, trans,
    rec, cnt, nsig, niter, itk) over [R, P]."""
    acc, trans, rec, cnt, nsig, niter, itk = state
    k_record = slots.numel()
    dx = px - gm[:, 0:1]
    dy = py - gm[:, 1:2]
    power = (-0.5 * (gc[:, 0:1] * dx * dx + gc[:, 2:3] * dy * dy)
             - gc[:, 1:2] * dx * dy)
    alpha = torch.clamp(gop * torch.exp(power), max=ALPHA_MAX)
    valid = (power <= 0.0) & (gid >= 0)
    active = (trans > TRANSMITTANCE_EPS) & live
    contrib = (alpha > ALPHA_SIGNIFICANT) & valid & active

    w = torch.where(contrib, trans * alpha, 0.0)
    acc = acc + w[..., None] * gcol[:, None, :]
    trans = torch.where(contrib, trans * (1.0 - alpha), trans)
    can = contrib & (cnt < k_record)
    put = (slots == cnt[..., None]) & can[..., None]
    rec = torch.where(put, gid[..., None], rec)
    new_cnt = cnt + can.int()
    itk = torch.where((new_cnt == k_record) & (cnt < k_record), i + 1, itk)
    nsig = nsig + contrib.int()
    niter = niter + (active & (gid >= 0)).int()
    return acc, trans, rec, new_cnt, nsig, niter, itk


def _dense_chunk(px, py, live, slots, start: int, mean2d, conic, color,
                 opacity, ids, *state):
    """The dense walk over one chunk of list positions ``start ..`` for
    every tile; the features are the chunk's [T, chunk, ...] slices."""
    for j in range(ids.shape[1]):
        state = _walk_step(px, py, live, state, mean2d[:, j], conic[:, j],
                           color[:, j], opacity[:, j, None], ids[:, j, None],
                           start + j, slots)
    return state


def rasterize_tiles(feats: TileFeatures, tiles_x: int, *, k_record: int = 5,
                    bg: float = 0.0, live=None, chunk: int = 64,
                    early_exit: bool = True, first_tile: int = 0
                    ) -> tuple[torch.Tensor, RasterAux]:
    """Integrate colors for all tiles (``feats`` holding the tiles from
    ``first_tile`` on, a block of the grid, where it is not 0).

    ``live`` is anything broadcastable to [T, P] bool: dead pixels contribute
    nothing and count zero iterations.

    With ``early_exit`` (the default) the walk is chunked behind a per-tile
    early exit: a tile stops once every live pixel's transmittance bottoms
    out or its last valid Gaussian is behind it, and only the running tiles'
    rows are walked (one host sync a chunk, rows written back in place).
    The skipped iterations could never change an output.

    ``early_exit=False`` is the dense walk over all K entries of every tile:
    no row selection and no host sync, so autograd passes through it (the
    fine-tuning loss renders this way).  Its outputs are bit-identical to
    the early-exit walk's.  It walks ``chunk`` positions at a time; with
    grad on, each chunk runs under activation checkpointing and is
    recomputed in backward, so only the carries at chunk boundaries are
    kept (at 1920x1080 and K = 1024, every position's residuals would not
    fit in 80 GB).  Integer outputs carry no gradient.

    Returns (tile_colors [T, P, 3], aux).
    """
    num_tiles, k = feats.ids.shape
    dev = feats.ids.device
    px, py = pixel_centers(tiles_x, num_tiles, dev, first_tile)
    live_tp = torch.broadcast_to(
        torch.as_tensor(True if live is None else live, device=dev),
        (num_tiles, P))

    acc = torch.zeros((num_tiles, P, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, P), dtype=torch.float32, device=dev)
    rec = torch.full((num_tiles, P, k_record), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((num_tiles, P), dtype=torch.int32, device=dev)
    nsig = torch.zeros_like(cnt)
    niter = torch.zeros_like(cnt)
    itk = torch.full_like(cnt, k)        # iter_at_k defaults to "all of them"
    slots = torch.arange(k_record, dtype=torch.int32, device=dev)

    if early_exit:
        acc, trans, rec, nsig, niter, itk = _walk_chunked(
            feats, chunk, px, py, live_tp, slots,
            (acc, trans, rec, cnt, nsig, niter, itk))
    else:
        state = (acc, trans, rec, cnt, nsig, niter, itk)
        grad = torch.is_grad_enabled()
        for c0 in range(0, k, chunk):
            sl = slice(c0, c0 + chunk)
            args = (px, py, live_tp, slots, c0, feats.mean2d[:, sl],
                    feats.conic[:, sl], feats.color[:, sl],
                    feats.opacity[:, sl], feats.ids[:, sl], *state)
            state = (checkpoint(_dense_chunk, *args, use_reentrant=False)
                     if grad else _dense_chunk(*args))
        acc, trans, rec, _, nsig, niter, itk = state

    acc = acc + trans[..., None] * bg
    aux = RasterAux(alpha_record=rec, n_significant=nsig, n_iterated=niter,
                    iter_at_k=itk, transmittance=trans)
    return acc, aux


def _walk_chunked(feats: TileFeatures, chunk: int, px, py, live_tp, slots,
                  state):
    """The early-exit walk: each chunk over the rows of the tiles still
    running, written back in place.  Returns (acc, trans, rec, nsig, niter,
    itk).

    On the ``meta`` device there are no values to decide which tiles still
    run, so the walk takes its static worst case: every row through all
    ``capacity / chunk`` chunks.  It dispatches the ops of a real walk in
    which every tile runs to its last chunk, so a dry run's count bounds
    any real walk's from above."""
    feats = pad_tile_features(feats, chunk)
    ncap = chunk_caps(feats.ids, chunk)
    n_chunks = feats.ids.shape[1] // chunk
    meta = feats.ids.device.type == 'meta'
    state = list(state)
    c = 0
    while True:
        trans = state[1]
        running = (c < ncap) & (live_tp & (trans > TRANSMITTANCE_EPS)).any(1)
        if meta:     # every row until the last chunk (shapes only: no pads)
            rows = torch.nonzero_static(
                running, size=running.shape[0] if c < n_chunks else 0)
        else:
            rows = running.nonzero()
        rows = rows.squeeze(1)
        if rows.numel() == 0:
            break
        r_px, r_py, r_live = px[rows], py[rows], live_tp[rows]
        r_state = tuple(x[rows] for x in state)
        for i in range(c * chunk, (c + 1) * chunk):
            r_state = _walk_step(
                r_px, r_py, r_live, r_state, feats.mean2d[rows, i],
                feats.conic[rows, i], feats.color[rows, i],
                feats.opacity[rows, i][:, None], feats.ids[rows, i][:, None],
                i, slots)
        for x, r in zip(state, r_state):
            x[rows] = r
        c += 1
    acc, trans, rec, _, nsig, niter, itk = state
    return acc, trans, rec, nsig, niter, itk


def assemble_image(tile_colors: torch.Tensor, tiles_x: int, tiles_y: int,
                   width: int, height: int) -> torch.Tensor:
    """[T, P, 3] tile colors -> [H, W, 3] image (crops tile padding)."""
    img = tile_colors.reshape(tiles_y, tiles_x, TILE, TILE, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, 3)
    return img[:height, :width]


def scatter_tile_pixels(values: torch.Tensor, tiles_x: int, tiles_y: int,
                        width: int, height: int) -> torch.Tensor:
    """Like ``assemble_image`` but for scalar per-pixel stats: [T, P] -> [H, W]."""
    img = values.reshape(tiles_y, tiles_x, TILE, TILE)
    img = img.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)
    return img[:height, :width]
