"""The kernel path of a frame's shade — wrappers over the rasterize and
lookup kernels:

  * ``rasterize_full``     — baseline / S^2-only rasterization;
  * ``rasterize_prefix``   — RC phase A: integrate until each pixel's
                             alpha-record fills (or terminates);
  * ``rasterize_resume``   — RC phase B: cache-miss pixels continue from
                             their saved state;
  * ``rasterize_resume_compacted`` — phase B over miss-compacted tiles;
  * ``rc_lookup`` / ``rc_probe``   — LuminCache probe (+ LRU touch);
  * ``rasterize_with_rc``  — the cached-rasterization pipeline
                             (A -> lookup -> B -> insert), with the compute
                             savings realized at chunk granularity.

The kernel design is chosen by the tensors' device: plain versions on the
CPU, the CUDA kernels on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import radiance_cache as rc
from ..core.gaussians import ALPHA_SIGNIFICANT, TRANSMITTANCE_EPS
from ..core.groups import regroup, ungroup
from ..core.rasterize import P, RasterAux, chunk_caps, pad_tile_features
from ..core.tiling import TILE, TileFeatures
from . import rasterize as rk
from .rc_lookup import rc_lookup as _rc_lookup_kernel

pad_features = pad_tile_features


def trim_features(feats: TileFeatures, tiles_x: int) -> TileFeatures:
    """Drop per-tile list entries that provably cannot be *significant*
    anywhere in their tile, and compact survivors to the front.

    An entry is kept iff the level-set ellipse ``alpha == ALPHA_SIGNIFICANT``
    (axis-aligned bbox of the conic quadratic at ``q = 2 ln(opacity /
    alpha_sig)``, inflated by a safety margin so float rounding can never
    flip a decision) overlaps its tile.  Only insignificant evaluations are
    dropped, so images, alpha-records and cache decisions are unchanged;
    the *examined* counter (``n_iterated``) shrinks.
    """
    t = feats.ids.shape[0]
    a = feats.conic[..., 0]
    b = feats.conic[..., 1]
    c = feats.conic[..., 2]
    op = feats.opacity
    # alpha > sig  <=>  a dx^2 + 2b dx dy + c dy^2 < 2 ln(op / sig)
    q = 2.0 * torch.log(torch.clamp(op, min=1e-12) / ALPHA_SIGNIFICANT)
    can_sig = q > 0.0
    det = torch.clamp(a * c - b * b, min=1e-12)
    q_safe = torch.clamp(q, min=0.0) * 1.02          # float-rounding headroom
    rx = torch.sqrt(q_safe * c / det) + 0.5          # bbox half-extents + margin
    ry = torch.sqrt(q_safe * a / det) + 0.5

    tix = torch.arange(t, dtype=torch.int32, device=op.device)
    x0 = ((tix % tiles_x) * TILE).float()[:, None]
    y0 = ((tix // tiles_x) * TILE).float()[:, None]
    mx, my = feats.mean2d[..., 0], feats.mean2d[..., 1]
    overlap = ((mx + rx >= x0) & (mx - rx <= x0 + TILE)
               & (my + ry >= y0) & (my - ry <= y0 + TILE))
    keep = overlap & can_sig & (feats.ids >= 0)

    # stable partition: survivors first, depth order preserved
    perm = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    kept = torch.gather(keep, 1, perm)

    def g(x):
        if x.ndim == 3:
            return torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[2]))
        return torch.gather(x, 1, perm)

    return TileFeatures(mean2d=g(feats.mean2d), conic=g(feats.conic),
                        color=g(feats.color),
                        opacity=torch.where(kept, g(feats.opacity), 0.0),
                        ids=torch.where(kept, g(feats.ids), -1))


def _baseline_state(t: int, k_record: int, live, device):
    i32 = torch.int32
    live_tp = torch.broadcast_to(
        torch.as_tensor(True if live is None else live, device=device),
        (t, P)).to(i32).contiguous()
    return (torch.zeros((t, P, 3), dtype=torch.float32, device=device),
            torch.ones((t, P), dtype=torch.float32, device=device),
            torch.full((t, P, k_record), -1, dtype=i32, device=device),
            torch.zeros((t, P), dtype=i32, device=device),
            torch.zeros((t, P), dtype=i32, device=device),    # start_iter
            live_tp)                                           # live


def _features(feats: TileFeatures):
    return tuple(x.contiguous() for x in (feats.mean2d, feats.conic,
                                          feats.color, feats.opacity,
                                          feats.ids))


def _to_aux(st: rk.RasterState) -> RasterAux:
    return RasterAux(alpha_record=st.record, n_significant=st.n_sig,
                     n_iterated=st.n_iter, iter_at_k=st.iter_at_k,
                     transmittance=st.trans)


def rasterize_full(feats: TileFeatures, tiles_x: int, *, k_record: int = 5,
                   chunk: int = 64, bg: float = 0.0, live=None):
    """Baseline rasterization.  Returns (tile_colors [T,P,3], RasterAux,
    chunks [T,1]).  ``live`` (broadcastable to [T, P] bool) masks dead
    pixels: they contribute nothing and count zero iterations."""
    feats = pad_features(feats, chunk)
    t = feats.ids.shape[0]
    st = rk.rasterize(*_features(feats),
                      *_baseline_state(t, k_record, live, feats.ids.device),
                      chunk_caps(feats.ids, chunk), tiles_x=tiles_x,
                      k_record=k_record, chunk=chunk, stop_at_k=False)
    colors = st.acc + st.trans[..., None] * bg
    return colors, _to_aux(st), st.chunks


def rasterize_prefix(feats: TileFeatures, tiles_x: int, *, k_record: int = 5,
                     chunk: int = 64, live=None) -> rk.RasterState:
    """RC phase A.  K must already be padded (call pad_features first)."""
    t = feats.ids.shape[0]
    return rk.rasterize(*_features(feats),
                        *_baseline_state(t, k_record, live, feats.ids.device),
                        chunk_caps(feats.ids, chunk), tiles_x=tiles_x,
                        k_record=k_record, chunk=chunk, stop_at_k=True)


def resume_live_mask(state_a: rk.RasterState, miss: torch.Tensor,
                     k_record: int) -> torch.Tensor:
    """Which pixels phase B must integrate: cache misses whose record filled
    in phase A (others already completed) and whose transmittance has not
    bottomed out."""
    return (miss & (state_a.rec_cnt >= k_record)
            & (state_a.trans > TRANSMITTANCE_EPS))


def _combine_resume(state_a: rk.RasterState, st: rk.RasterState, bg: float):
    colors = st.acc + st.trans[..., None] * bg
    aux = RasterAux(alpha_record=st.record,
                    n_significant=state_a.n_sig + st.n_sig,
                    n_iterated=state_a.n_iter + st.n_iter,
                    iter_at_k=torch.minimum(state_a.iter_at_k, st.iter_at_k),
                    transmittance=st.trans)
    return colors, aux, st.chunks


def rasterize_resume(feats: TileFeatures, tiles_x: int,
                     state_a: rk.RasterState, miss: torch.Tensor, *,
                     k_record: int = 5, chunk: int = 64, bg: float = 0.0):
    """RC phase B over whole tiles: continue integration for miss pixels
    whose record filled.  ``miss`` [T, P] bool.  Returns (tile_colors,
    RasterAux, chunks)."""
    live = resume_live_mask(state_a, miss, k_record).to(torch.int32)
    st = rk.rasterize(*_features(feats), state_a.acc, state_a.trans,
                      state_a.record, state_a.rec_cnt, state_a.iter_at_k, live,
                      chunk_caps(feats.ids, chunk), tiles_x=tiles_x,
                      k_record=k_record, chunk=chunk, stop_at_k=False)
    return _combine_resume(state_a, st, bg)


def rasterize_resume_compacted(feats: TileFeatures, tiles_x: int,
                               state_a: rk.RasterState, miss: torch.Tensor,
                               *, k_record: int = 5, chunk: int = 64,
                               bg: float = 0.0):
    """RC phase B with **miss compaction** — LuminCore's PE remap in software.

    The miss pixels of the whole frame are gathered (with their phase-A
    state) into dense compacted tiles, live lanes first and each half in
    source-tile-major order (a stable partition), so only those tiles walk
    the chunk loop and phase-B chunk count scales with the miss count, not
    the tile count.  Results scatter back to their home pixels.  Integer
    state equals ``rasterize_resume``'s exactly.
    """
    t, p = state_a.trans.shape
    dev = state_a.trans.device
    live = resume_live_mask(state_a, miss, k_record)

    flat = live.reshape(-1).to(torch.int32)                    # [T*P]
    n_live = flat.sum()
    rank_live = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    rank_dead = torch.cumsum(1 - flat, 0, dtype=torch.int32) - 1 + n_live
    dest = torch.where(flat != 0, rank_live, rank_dead).long()  # [T*P]
    perm = torch.empty_like(dest)
    perm[dest] = torch.arange(t * p, device=dev)               # dest is a permutation

    idx = torch.arange(t * p, dtype=torch.int32, device=dev)
    tix, pix = idx // p, idx % p
    px = ((tix % tiles_x) * TILE + pix % TILE).float() + 0.5
    py = ((tix // tiles_x) * TILE + pix // TILE).float() + 0.5
    ncap_t = chunk_caps(feats.ids, chunk)

    def gather(x):
        return x.reshape(t * p, *x.shape[2:])[perm].reshape(t, p, *x.shape[2:])

    st = rk.rasterize_compact(
        *_features(feats), gather(px.reshape(t, p)), gather(py.reshape(t, p)),
        gather(tix.reshape(t, p)), gather(ncap_t[tix.long()].reshape(t, p)),
        gather(state_a.acc), gather(state_a.trans), gather(state_a.record),
        gather(state_a.rec_cnt), gather(state_a.iter_at_k),
        gather(live.to(torch.int32)), k_record=k_record, chunk=chunk)

    def scatter(x):
        return x.reshape(t * p, *x.shape[2:])[dest].reshape(t, p, *x.shape[2:])

    # chunk counts belong to compacted tiles; their sum is the phase-B cost
    st = rk.RasterState(
        acc=scatter(st.acc), trans=scatter(st.trans), record=scatter(st.record),
        rec_cnt=scatter(st.rec_cnt), n_sig=scatter(st.n_sig),
        n_iter=scatter(st.n_iter), iter_at_k=scatter(st.iter_at_k),
        chunks=st.chunks)
    return _combine_resume(state_a, st, bg)


def rc_lookup(cache: rc.CacheState, ids: torch.Tensor, cfg: rc.CacheConfig):
    """LuminCache probe for all groups (ids [G, B, k]): (hit, value,
    set_idx, way).  The cache is left untouched."""
    return _rc_lookup_kernel(cache.tags, cache.values, ids.contiguous(), cfg)


def rc_probe(cache: rc.CacheState, ids_g: torch.Tensor, cfg: rc.CacheConfig):
    """Cache lookup + LRU touch for one viewer: the probe, then the touch as
    a separate step.  Returns (hit_g, val_g, way_g, cache-with-touch)."""
    hit_g, val_g, sidx_g, way_g = rc_lookup(cache, ids_g, cfg)
    cache = rc.touch_all_groups(cache, ids_g, hit_g, way_g.long(), cfg,
                                sidx=sidx_g.long())
    return hit_g, val_g, way_g, cache


@dataclasses.dataclass(frozen=True)
class RCStats:
    """Kernel-path statistics.  Compute savings are chunk-granular: compare
    (chunks_prefix + chunks_resume) against ``chunks_bound`` (what a
    count-capped full pass over the same tiles would cost)."""

    hit_rate: torch.Tensor
    chunks_prefix: torch.Tensor   # chunk iterations, phase A (sum over tiles)
    chunks_resume: torch.Tensor   # chunk iterations, phase B
    chunks_bound: torch.Tensor    # count-capped full-pass chunk total
    hit: torch.Tensor             # [T, P] bool per-pixel cache-hit mask


def rasterize_with_rc(feats: TileFeatures, tiles_x: int, tiles_y: int,
                      cache: rc.CacheState, cfg: rc.CacheConfig,
                      group_tiles: int, *, k_record: int = 5, chunk: int = 64,
                      bg: float = 0.0, live=None, compact: bool = True):
    """Cached rasterization in hardware-phase order (A -> lookup -> B ->
    insert).  ``live`` (broadcastable to [T, P] bool) masks dead pixels out
    of both phases; ``compact`` routes phase B through the miss-compacted
    resume.  Returns (final tile colors [T,P,3], new cache, RasterAux,
    RCStats)."""
    feats = pad_features(feats, chunk)
    st_a = rasterize_prefix(feats, tiles_x, k_record=k_record, chunk=chunk,
                            live=live)
    ids_g = regroup(st_a.record, tiles_x, tiles_y, group_tiles)
    hit_g, val_g, way_g, cache = rc_probe(cache, ids_g, cfg)
    hit = ungroup(hit_g[..., None], tiles_x, tiles_y, group_tiles)[..., 0]
    cached = ungroup(val_g, tiles_x, tiles_y, group_tiles)

    miss = ~hit
    if live is not None:
        miss = miss & torch.broadcast_to(
            torch.as_tensor(live, device=miss.device), miss.shape)
    resume = rasterize_resume_compacted if compact else rasterize_resume
    colors, aux, chunks_b = resume(feats, tiles_x, st_a, miss,
                                   k_record=k_record, chunk=chunk, bg=bg)
    final = torch.where(hit[..., None], cached, colors)

    # cache update: completed (miss) pixels insert their fresh values
    raw_g = regroup(colors, tiles_x, tiles_y, group_tiles)
    cache = rc.insert_all_groups(cache, ids_g, raw_g, ~hit_g, cfg)

    stats = RCStats(hit_rate=hit.float().mean(),
                    chunks_prefix=st_a.chunks.sum(),
                    chunks_resume=chunks_b.sum(),
                    chunks_bound=chunk_caps(feats.ids, chunk).sum(),
                    hit=hit)
    return final, cache, aux, stats
