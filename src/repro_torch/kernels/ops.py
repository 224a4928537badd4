"""The kernel path of a frame's shade — wrappers over the rasterize and
lookup kernels:

  * ``rasterize_full``     — baseline / S^2-only rasterization;
  * ``rasterize_prefix``   — RC phase A: integrate until each pixel's
                             alpha-record fills (or terminates);
  * ``rasterize_resume``   — RC phase B: cache-miss pixels continue from
                             their saved state;
  * ``rasterize_resume_compacted`` — phase B over miss-compacted lanes,
                             addressed through their home pixels;
  * ``rc_probe(_multi)``   — LuminCache probe + LRU touch;
  * ``rasterize_with_rc``  — the cached-rasterization pipeline
                             (A -> lookup -> B -> insert), with the compute
                             savings realized at chunk granularity;
  * ``*_slots``            — the slot-batched forms of the multi-viewer
                             serving tick: phase A for all slots in one
                             ``rasterize_slots`` launch, the scene-shared
                             probe, phase B compacted across slots, the
                             scene-shared insert.

The kernel design is chosen by the tensors' device: plain versions on the
CPU, the CUDA kernels on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import radiance_cache as rc
from ..core.gaussians import ALPHA_SIGNIFICANT, TRANSMITTANCE_EPS
from ..core.groups import regroup, regroup_slots, ungroup, ungroup_slots
from ..core.rasterize import P, RasterAux, chunk_caps, pad_tile_features
from ..core.tiling import TILE, TileFeatures
from . import rasterize as rk
from .rc_lookup import rc_probe as _rc_probe_kernel

pad_features = pad_tile_features


def trim_features(feats: TileFeatures, tiles_x: int,
                  t_img: int | None = None) -> TileFeatures:
    """Drop per-tile list entries that provably cannot be *significant*
    anywhere in their tile, and compact survivors to the front.

    An entry is kept iff the level-set ellipse ``alpha == ALPHA_SIGNIFICANT``
    (axis-aligned bbox of the conic quadratic at ``q = 2 ln(opacity /
    alpha_sig)``, inflated by a safety margin so float rounding can never
    flip a decision) overlaps its tile.  Only insignificant evaluations are
    dropped, so images, alpha-records and cache decisions are unchanged;
    the *examined* counter (``n_iterated``) shrinks.

    ``t_img``: tiles per image when the leading axis flattens slot x tile
    (the slot-batched path); defaults to "all tiles are one image".
    """
    t = feats.ids.shape[0]
    timg = t if t_img is None else t_img
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

    tix = torch.arange(t, dtype=torch.int32, device=op.device) % timg
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


def compaction_order(live: torch.Tensor):
    """The compacted order of the lanes of a [T, P] live mask: live lanes
    first, each half in flat (source-tile-major) order, a stable partition
    computed on the device without a host sync.  Returns (home [T * P]
    int32, the flat home index of each lane of that order; n_live, a 0-dim
    int32 tensor)."""
    i32 = torch.int32
    flat = live.reshape(-1).to(i32)
    n_live = flat.sum(dtype=i32)
    idx = torch.arange(flat.numel(), dtype=i32, device=flat.device)
    rank_live = torch.cumsum(flat, 0, dtype=i32)          # live lanes up to i
    # live lane i goes to rank_live - 1, dead lane i after every live lane
    dest = torch.where(flat != 0, rank_live - 1, idx - rank_live + n_live)
    home = torch.empty_like(idx)
    home[dest.long()] = idx                                # dest is a permutation
    return home, n_live


def rasterize_resume_compacted(feats: TileFeatures, tiles_x: int,
                               state_a: rk.RasterState, miss: torch.Tensor,
                               *, k_record: int = 5, chunk: int = 64,
                               bg: float = 0.0, t_img: int | None = None):
    """RC phase B with **miss compaction** — LuminCore's PE remap in software.

    The live lanes of the whole frame (miss pixels that phase B must
    integrate) are ordered live first, each half in source-tile-major order
    (a stable partition, computed on the device without a host sync), and
    grouped 256 to a lane tile, so phase B's chunk count scales with the
    miss count, not the tile count.  ``rk.rasterize_compact_home`` walks
    them through their home indices: on the card only live lanes are read
    and written, the rest keep phase A's state.  Integer state equals
    ``rasterize_resume``'s exactly.

    ``t_img`` = tiles per image: when the leading axis flattens slot x tile
    (cross-slot compaction in the serving tick), pixel coordinates repeat
    every ``t_img`` tiles.
    """
    t = state_a.trans.shape[0]
    home, n_live = compaction_order(resume_live_mask(state_a, miss, k_record))
    st = rk.rasterize_compact_home(
        *_features(feats), chunk_caps(feats.ids, chunk), state_a.acc,
        state_a.trans, state_a.record, state_a.rec_cnt, state_a.n_sig,
        state_a.n_iter, state_a.iter_at_k, home, n_live, tiles_x=tiles_x,
        t_img=t if t_img is None else t_img, k_record=k_record, chunk=chunk)
    # chunk counts belong to lane tiles; their sum is the phase-B cost
    colors = st.acc + st.trans[..., None] * bg
    return colors, _to_aux(st), st.chunks


def rc_probe(cache: rc.CacheState, ids_g: torch.Tensor, cfg: rc.CacheConfig):
    """Cache lookup + LRU touch for one viewer (``rc_probe_multi`` with V =
    1): ids_g [G, B, k].  Returns (hit_g, val_g, way_g, cache-with-touch)."""
    return rc_probe_multi(cache, ids_g, cfg)


def rc_probe_multi(cache: rc.CacheState, ids: torch.Tensor,
                   cfg: rc.CacheConfig, live: torch.Tensor | None = None):
    """Shared-cache probe for V viewers: ids [V, G, B, k] (or [G, B, k] for
    one viewer), live [V] (or [V, G]) bool.  Returns (hit [V,G,B], val
    [V,G,B,3], way [V,G,B], cache-with-touch).  The viewer axis flattens
    slot-major into each group's batch, so the LRU evolves in (slot, pixel)
    order and V == 1 is ``rc_probe``; dead viewers probe without touching.
    On the card the lookup and the touch are one launch that reads the ids
    where they lie."""
    hit, val, way, age, clock = _rc_probe_kernel(
        cache.tags, cache.values, cache.age, cache.clock, ids.contiguous(), cfg,
        live=live)
    return hit, val, way, rc.CacheState(cache.tags, cache.values, age, clock)


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


# ---------------------------------------------------------------------------
# Slot-batched wrappers: the multi-viewer serving tick
# ---------------------------------------------------------------------------
# Phase A runs every slot's lanes in one ``rasterize_slots`` launch, phase B
# compacts cache misses across all slots, and the cache stages run over the
# scene caches flattened to C * G groups.  Per lane the results equal the
# per-slot functions'; only the phase-A chunk count is shared by the slots.

def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _unflat(x: torch.Tensor, s: int) -> torch.Tensor:
    return x.reshape(s, x.shape[0] // s, *x.shape[1:])


def pad_features_slots(feats_b: TileFeatures, chunk: int) -> TileFeatures:
    """``pad_features`` for [S, T, K, ...] feature stacks."""
    s = feats_b.ids.shape[0]
    flat = pad_features(TileFeatures(*map(_flat, _features(feats_b))), chunk)
    return TileFeatures(*(_unflat(x, s) for x in _features(flat)))


def _slots_state(s: int, t: int, k_record: int, live, device) -> tuple:
    i32 = torch.int32
    live_stp = torch.broadcast_to(
        torch.as_tensor(live, dtype=torch.bool, device=device).reshape(s, 1, 1),
        (s, t, P)).to(i32).contiguous()
    return (torch.zeros((s, t, P, 3), dtype=torch.float32, device=device),
            torch.ones((s, t, P), dtype=torch.float32, device=device),
            torch.full((s, t, P, k_record), -1, dtype=i32, device=device),
            torch.zeros((s, t, P), dtype=i32, device=device),
            live_stp)


def _slots_caps(feats_b: TileFeatures, chunk: int) -> torch.Tensor:
    s = feats_b.ids.shape[0]
    return _unflat(chunk_caps(_flat(feats_b.ids), chunk), s)


def _live_slots(live, s: int, device) -> torch.Tensor:
    if live is None:
        return torch.ones((s,), dtype=torch.bool, device=device)
    return torch.as_tensor(live, dtype=torch.bool, device=device).reshape(s)


def rasterize_prefix_slots(feats_b: TileFeatures, tiles_x: int, *,
                           k_record: int = 5, chunk: int = 64,
                           live=None) -> rk.RasterState:
    """RC phase A for all serving slots in one ``rasterize_slots`` launch.
    ``feats_b`` leaves are [S, T, K, ...], pre-padded
    (``pad_features_slots``); ``live`` is [S] bool.  Returns [S, T, P, ...]
    state; ``chunks`` [T, 1] is the trip count shared by the slots."""
    s, t = feats_b.ids.shape[:2]
    dev = feats_b.ids.device
    return rk.rasterize_slots(
        *_features(feats_b),
        *_slots_state(s, t, k_record, _live_slots(live, s, dev), dev),
        _slots_caps(feats_b, chunk), tiles_x=tiles_x, k_record=k_record,
        chunk=chunk, stop_at_k=True)


def rasterize_full_slots(feats_b: TileFeatures, tiles_x: int, *,
                         k_record: int = 5, chunk: int = 64, bg: float = 0.0,
                         live=None):
    """Slot-batched baseline rasterization (no RC).  Returns (colors
    [S,T,P,3], RasterAux with [S,T,P,...] leaves, chunks [T,1])."""
    feats_b = pad_features_slots(feats_b, chunk)
    s, t = feats_b.ids.shape[:2]
    dev = feats_b.ids.device
    st = rk.rasterize_slots(
        *_features(feats_b),
        *_slots_state(s, t, k_record, _live_slots(live, s, dev), dev),
        _slots_caps(feats_b, chunk), tiles_x=tiles_x, k_record=k_record,
        chunk=chunk, stop_at_k=False)
    colors = st.acc + st.trans[..., None] * bg
    return colors, _to_aux(st), st.chunks


def rasterize_resume_compacted_slots(feats_b: TileFeatures, tiles_x: int,
                                     st_a: rk.RasterState, miss: torch.Tensor,
                                     *, t_img: int, k_record: int = 5,
                                     chunk: int = 64, bg: float = 0.0):
    """Cross-slot miss-compacted phase B: the miss pixels of every slot pack
    into one run of compacted tiles.  ``feats_b``/``st_a``/``miss`` carry
    [S, T, ...] leaves; ``t_img`` = tiles per image (= T)."""
    s = feats_b.ids.shape[0]
    st_f = rk.RasterState(
        acc=_flat(st_a.acc), trans=_flat(st_a.trans),
        record=_flat(st_a.record), rec_cnt=_flat(st_a.rec_cnt),
        n_sig=_flat(st_a.n_sig), n_iter=_flat(st_a.n_iter),
        iter_at_k=_flat(st_a.iter_at_k), chunks=st_a.chunks)
    colors, aux, chunks_b = rasterize_resume_compacted(
        TileFeatures(*map(_flat, _features(feats_b))), tiles_x, st_f,
        _flat(miss), k_record=k_record, chunk=chunk, bg=bg, t_img=t_img)
    aux = RasterAux(alpha_record=_unflat(aux.alpha_record, s),
                    n_significant=_unflat(aux.n_significant, s),
                    n_iterated=_unflat(aux.n_iterated, s),
                    iter_at_k=_unflat(aux.iter_at_k, s),
                    transmittance=_unflat(aux.transmittance, s))
    return _unflat(colors, s), aux, chunks_b


def rasterize_with_rc_slots(feats_b: TileFeatures, tiles_x: int, tiles_y: int,
                            caches: rc.CacheState, cfg: rc.CacheConfig,
                            group_tiles: int, *, viewers_per_scene: int = 1,
                            k_record: int = 5, chunk: int = 64,
                            bg: float = 0.0, live=None, compact: bool = True):
    """Slot-batched cached rasterization: phase A in one ``rasterize_slots``
    launch, scene-shared probe, cross-slot miss-compacted phase B,
    scene-shared insert.  ``caches`` leaves carry a leading [C] axis, C = S
    // ``viewers_per_scene`` (slot i probes scene i // V's cache, conflicts
    resolving in (slot, pixel) order); ``live`` [S] bool masks idle slots
    out of the LRU touches, the inserts and the chunk loops.  Per lane the
    results equal ``rasterize_with_rc`` mapped over the slots; the chunk
    counts are fleet totals (phase A's trip count is shared by the slots,
    so ``chunks_prefix`` scales it by S) and ``hit_rate`` is [S].
    Returns (final colors [S,T,P,3], new caches, RasterAux, RCStats)."""
    feats_b = pad_features_slots(feats_b, chunk)
    s, t = feats_b.ids.shape[:2]
    v = viewers_per_scene
    c = s // v
    dev = feats_b.ids.device
    live = _live_slots(live, s, dev)

    st_a = rasterize_prefix_slots(feats_b, tiles_x, k_record=k_record,
                                  chunk=chunk, live=live)
    ids_g = regroup_slots(st_a.record, tiles_x, tiles_y, group_tiles)
    live_g = live[:, None].expand(s, ids_g.shape[1])           # [S, G]
    ids_v = rc.viewer_major(ids_g, v)                           # [V, C*G, B, k]
    live_v = rc.viewer_major(live_g, v)
    hit_v, val_v, _, cache_f = rc_probe_multi(rc.flatten_scenes(caches),
                                              ids_v, cfg, live=live_v)
    hit_g = rc.slot_order(hit_v, c)                             # [S, G, B]
    hit = ungroup_slots(hit_g[..., None], tiles_x, tiles_y, group_tiles)[..., 0]
    cached = ungroup_slots(rc.slot_order(val_v, c), tiles_x, tiles_y,
                           group_tiles)

    miss = ~hit & live[:, None, None]
    if compact:
        colors, aux, chunks_b = rasterize_resume_compacted_slots(
            feats_b, tiles_x, st_a, miss, t_img=t, k_record=k_record,
            chunk=chunk, bg=bg)
    else:
        outs = [rasterize_resume(
            TileFeatures(*(x[i] for x in _features(feats_b))), tiles_x,
            rk.RasterState(st_a.acc[i], st_a.trans[i], st_a.record[i],
                           st_a.rec_cnt[i], st_a.n_sig[i], st_a.n_iter[i],
                           st_a.iter_at_k[i], chunks=st_a.chunks),
            miss[i], k_record=k_record, chunk=chunk, bg=bg) for i in range(s)]
        colors = torch.stack([o[0] for o in outs])
        aux = RasterAux(*(torch.stack([getattr(o[1], f) for o in outs])
                          for f in ('alpha_record', 'n_significant',
                                    'n_iterated', 'iter_at_k',
                                    'transmittance')))
        chunks_b = torch.stack([o[2] for o in outs])
    final = torch.where(hit[..., None], cached, colors)

    raw_v = rc.viewer_major(regroup_slots(colors, tiles_x, tiles_y,
                                          group_tiles), v)
    cache_f = rc.insert_all_groups_multi(cache_f, ids_v, raw_v,
                                         ~hit_v & rc.viewer_live(live_v,
                                                                 hit_v.shape),
                                         cfg)
    stats = RCStats(hit_rate=hit.float().mean(dim=(1, 2)),           # [S]
                    # one shared trip covers all S slots' lanes of a tile,
                    # so scale by S to keep (prefix + resume) comparable
                    # with the bound, both in per-slot-tile chunk units
                    chunks_prefix=st_a.chunks.sum() * s,
                    chunks_resume=chunks_b.sum(),
                    chunks_bound=_slots_caps(feats_b, chunk).sum(),
                    hit=hit)                                          # [S, T, P]
    return final, rc.split_scenes(cache_f, c), aux, stats
