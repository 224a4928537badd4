"""RC — Radiance Caching (paper Sec. 3.2) as a functional set-associative cache.

Cache key  : the ids of the first ``k`` *significant* Gaussians a pixel's ray
             intersects (the alpha-record emitted by the rasterizer).
Cache value: the pixel RGB.
Geometry   : ``n_sets`` sets x ``n_ways`` ways, one independent cache per
             tile *group* (the paper shares one LuminCache across a 4x4 block
             of 16x16 tiles = 64x64 pixels).

Replacement is LRU via an age counter.  In-batch insert conflicts resolve
deterministically: the lowest pixel index wins, as the hardware's sequential
insert order would.  Every function here returns new tensors and leaves its
input ``CacheState`` untouched.

All groups are processed at once: per-group (set, way) slots are flattened
to one index ``g * S * W + set * W + way``, so a scatter over all groups is
one ``scatter_reduce_`` or ``index_put_`` call.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class CacheConfig(NamedTuple):
    n_sets: int = 1024
    n_ways: int = 4
    k: int = 5              # alpha-record length (ids per tag)
    index_bits_shift: int = 3   # paper uses bits [3:18]; index starts at bit 3
    index_mode: str = 'hash'    # 'hash' (mixed, default) | 'bitconcat' (paper HW)
    insert_rounds: int = 4      # batch-insert rounds (each lands <= 1 entry per slot)


@dataclasses.dataclass(frozen=True)
class CacheState:
    """Cache state; leading dim = tile group."""

    tags: torch.Tensor    # [G, S, W, k] int32 (-2 = invalid slot)
    values: torch.Tensor  # [G, S, W, 3] float32
    age: torch.Tensor     # [G, S, W] int32 (higher = more recently used)
    clock: torch.Tensor   # [G] int32 monotonic insert counter


INVALID_TAG = -2  # -1 is a legal record padding value, so invalid slots use -2
INT32_MIN = -2 ** 31
MIX_CONSTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1)
_MASK32 = 0xFFFFFFFF


def init_cache(num_groups: int, cfg: CacheConfig, device=None) -> CacheState:
    g, s, w, k = num_groups, cfg.n_sets, cfg.n_ways, cfg.k
    return CacheState(
        tags=torch.full((g, s, w, k), INVALID_TAG, dtype=torch.int32, device=device),
        values=torch.zeros((g, s, w, 3), dtype=torch.float32, device=device),
        age=torch.zeros((g, s, w), dtype=torch.int32, device=device),
        clock=torch.zeros((g,), dtype=torch.int32, device=device))


def occupancy(cache: CacheState) -> torch.Tensor:
    """Fraction of valid (non-invalid-tag) slots across all groups."""
    return (cache.tags != INVALID_TAG).any(dim=-1).float().mean()


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): split ``c`` in 16-bit
    halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def set_index(ids: torch.Tensor, cfg: CacheConfig) -> torch.Tensor:
    """Set index from the k record ids ([..., k] int32 -> [...] int64).

    'bitconcat' concatenates ``log2(n_sets)/k`` low bits of each id — exactly
    LuminCache's indexing (Fig. 16).  'hash' is a multiplicative mix of the
    same ids with uint32 wrap-around, emulated in int64 and masked to 32 bits
    after every step; it must stay in lockstep with ``csrc/rc_lookup.cu``.
    """
    if cfg.index_mode == 'bitconcat':
        bits_total = cfg.n_sets.bit_length() - 1   # log2(n_sets)
        per_id = max(1, bits_total // cfg.k)
        mask = (1 << per_id) - 1
        shifted = (ids >> cfg.index_bits_shift) & mask
        weights = torch.tensor([1 << (per_id * i) for i in range(cfg.k)],
                               dtype=torch.int32, device=ids.device)
        idx = (shifted * weights).sum(dim=-1, dtype=torch.int32)
        return (torch.abs(idx) % cfg.n_sets).long()
    u = (ids.long() + 3) & _MASK32
    h = _mul32(u[..., 0], MIX_CONSTS[0])
    for i in range(1, ids.shape[-1]):
        m = _mul32(u[..., i], MIX_CONSTS[i % len(MIX_CONSTS)])
        h = _mul32(h ^ m, 0x9E3779B1)
    h = h ^ (h >> 15)
    return h % cfg.n_sets


def _flat_slot(g_sw: int, sidx: torch.Tensor, way: torch.Tensor,
               n_ways: int) -> torch.Tensor:
    """[G, B] (set, way) -> flat index into a [G * S * W] view."""
    g = torch.arange(sidx.shape[0], device=sidx.device)[:, None]
    return g * g_sw + sidx * n_ways + way


def _gather_sets(x: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """x [G, S, ...] at sidx [G, B] -> [G, B, ...]."""
    g = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[g, sidx]


def _group_view(cache: CacheState, group: int) -> CacheState:
    return CacheState(cache.tags[group:group + 1], cache.values[group:group + 1],
                      cache.age[group:group + 1], cache.clock[group:group + 1])


def _with_group(cache: CacheState, group: int, sub: CacheState) -> CacheState:
    def put(full, part):
        full = full.clone()
        full[group:group + 1] = part
        return full
    return CacheState(put(cache.tags, sub.tags), put(cache.values, sub.values),
                      put(cache.age, sub.age), put(cache.clock, sub.clock))


def lookup(cache: CacheState, group: int, ids: torch.Tensor, cfg: CacheConfig,
           live: torch.Tensor | None = None):
    """Query one group's cache with B records (ids [B, k]).  Returns (hit
    [B], value [B,3], set_idx [B], way [B], cache-with-updated-LRU-age)."""
    hit, val, sidx, way, sub = lookup_all_groups(
        _group_view(cache, group), ids[None], cfg,
        live=None if live is None else live[None])
    return hit[0], val[0], sidx[0], way[0], _with_group(cache, group, sub)


def insert(cache: CacheState, group: int, ids: torch.Tensor, rgb: torch.Tensor,
           do_insert: torch.Tensor, cfg: CacheConfig) -> CacheState:
    """Insert B (ids -> rgb) entries into one group's cache where
    ``do_insert`` (see ``_insert_groups``)."""
    sub = _insert_groups(_group_view(cache, group), ids[None], rgb[None],
                         do_insert[None], cfg)
    return _with_group(cache, group, sub)


def lookup_all_groups(cache: CacheState, ids: torch.Tensor, cfg: CacheConfig,
                      live: torch.Tensor | None = None):
    """Query every group's cache with its B records (ids [G, B, k]).

    Returns (hit [G,B], value [G,B,3], set_idx [G,B], way [G,B],
    cache-with-updated-LRU-age).  ``live`` ([G, B] bool) suppresses the LRU
    touch for dead records; the clock still advances by the full batch."""
    sidx = set_index(ids, cfg)                               # [G, B]
    m = (_gather_sets(cache.tags, sidx) == ids[:, :, None, :]).all(dim=-1)
    hit = m.any(dim=-1)
    way = torch.argmax(m.to(torch.int32), dim=-1)            # first match
    val = _gather_sets(cache.values, sidx)
    val = torch.gather(val, 2, way[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]
    cache = touch_all_groups(cache, ids, hit, way, cfg, live=live, sidx=sidx)
    return hit, val, sidx, way, cache


def touch_all_groups(cache: CacheState, ids: torch.Tensor, hit: torch.Tensor,
                     way: torch.Tensor, cfg: CacheConfig,
                     live: torch.Tensor | None = None,
                     sidx: torch.Tensor | None = None) -> CacheState:
    """The LRU side effect of a lookup (age bump for hits) without
    re-probing — the kernel path's probe returns (hit, way) and leaves the
    cache untouched, then this runs.  Later pixels touch later."""
    g, b = hit.shape
    if sidx is None:
        sidx = set_index(ids, cfg)
    touched = hit if live is None else hit & live
    touch_age = (cache.clock[:, None] + 1
                 + torch.arange(b, dtype=torch.int32, device=hit.device))
    s, w = cache.age.shape[1:]
    age = cache.age.clone()
    age.view(-1).scatter_reduce_(
        0, _flat_slot(s * w, sidx, way.long(), w).reshape(-1),
        torch.where(touched, touch_age, -1).reshape(-1), 'amax')
    return CacheState(cache.tags, cache.values, age, cache.clock + b)


def _insert_round(tags, values, age, clock, sidx, ids, rgb, do_insert):
    """One insert round over all groups: at most one new entry lands per
    (set, way) slot.  Victim way = first invalid way, else least-recently
    used (min age).  Conflicts on a slot: lowest pixel index wins.  Only the
    winners are scattered, so the scatter's indices are unique.  ``tags``,
    ``values`` and ``age`` are updated in place."""
    g, s, w, k = tags.shape
    b = ids.shape[1]
    invalid = (_gather_sets(tags, sidx) == INVALID_TAG).all(dim=-1)   # [G,B,W]
    slot_age = torch.where(invalid, INT32_MIN, _gather_sets(age, sidx))
    victim = torch.argmin(slot_age, dim=-1)                           # [G,B]

    slot = _flat_slot(s * w, sidx, victim, w)                         # [G,B]
    pix = torch.arange(b, dtype=torch.int32, device=ids.device).expand(g, b)
    winner = torch.full((g * s * w,), b, dtype=torch.int32, device=ids.device)
    winner.scatter_reduce_(0, slot.reshape(-1),
                           torch.where(do_insert, pix, b).reshape(-1), 'amin')
    wins = do_insert & (winner[slot] == pix)

    gi, bi = wins.nonzero(as_tuple=True)
    dst = slot[gi, bi]
    tags.view(-1, k)[dst] = ids[gi, bi]
    values.view(-1, 3)[dst] = rgb[gi, bi]
    age.view(-1)[dst] = (clock[gi] + 1 + bi).to(torch.int32)
    return clock + b


def _insert_groups(cache: CacheState, ids: torch.Tensor, rgb: torch.Tensor,
                   do_insert: torch.Tensor, cfg: CacheConfig) -> CacheState:
    """Insert B (ids -> rgb) entries per group where ``do_insert``
    (ids [G, B, k], rgb [G, B, 3], do_insert [G, B]).

    Hardware inserts pixels serially; a vectorized batch can land at most one
    entry per slot per scatter, so ``cfg.insert_rounds`` rounds run.  Each
    round first re-probes the cache so duplicates of already-landed tags
    become hits and drop out of the insert set.
    """
    sidx = set_index(ids, cfg)
    tags, values, age = cache.tags.clone(), cache.values.clone(), cache.age.clone()
    clock = cache.clock
    pending = do_insert
    for _ in range(max(1, cfg.insert_rounds)):
        present = (_gather_sets(tags, sidx) == ids[:, :, None, :]).all(-1).any(-1)
        pending = pending & ~present
        clock = _insert_round(tags, values, age, clock, sidx, ids, rgb, pending)
    return CacheState(tags, values, age, clock)


def insert_all_groups(cache: CacheState, ids: torch.Tensor, rgb: torch.Tensor,
                      do_insert: torch.Tensor, cfg: CacheConfig) -> CacheState:
    """``_insert_groups`` behind the finite gate: a NaN/Inf escaping the
    rasterizer must not be published to a cache other viewers read back.
    The gate leaves the mask unchanged on finite data."""
    return _insert_groups(cache, ids, rgb,
                          do_insert & torch.isfinite(rgb).all(dim=-1), cfg)


# ---------------------------------------------------------------------------
# Multi-viewer (scene-shared) forms
# ---------------------------------------------------------------------------
# One cache serves every viewer of a scene.  The batched forms flatten the
# viewer axis *slot-major* into each group's record batch, so the probes and
# inserts evolve the cache exactly as one sequential stream issuing them in
# (slot, pixel) order would: the lowest slot, then the lowest pixel, wins an
# insert conflict, and duplicate records across viewers land once through
# the insert rounds' re-probe.  With V == 1 the flatten is the identity.
#
# The caches of C scenes are C * G independent groups: ``flatten_scenes``
# views [C, G, ...] leaves as [C * G, ...], and ``viewer_major`` lays the
# records of S = C * V slots out as [V, C * G, ...], so one call probes or
# fills every scene (the JAX package maps the single-scene forms over C).

def slot_major(x: torch.Tensor) -> torch.Tensor:
    """[V, G, B, ...] per-viewer grouped records -> [G, V*B, ...] one
    slot-major batch per group (viewer 0's pixels first)."""
    v, g, b = x.shape[:3]
    return torch.movedim(x, 0, 1).reshape(g, v * b, *x.shape[3:])


def slot_split(x: torch.Tensor, v: int) -> torch.Tensor:
    """Inverse of ``slot_major``: [G, V*B, ...] -> [V, G, B, ...]."""
    g, vb = x.shape[:2]
    return torch.movedim(x.reshape(g, v, vb // v, *x.shape[2:]), 1, 0)


def viewer_major(x: torch.Tensor, v: int) -> torch.Tensor:
    """[S, G, ...] per-slot grouped records of S = C * V slots (slot i in
    scene i // V) -> [V, C * G, ...], the viewers of each scene over the
    groups of the flattened scene caches."""
    s, g = x.shape[:2]
    x = x.reshape(s // v, v, g, *x.shape[2:])
    return torch.movedim(x, 1, 0).reshape(v, (s // v) * g, *x.shape[3:])


def slot_order(x: torch.Tensor, num_scenes: int) -> torch.Tensor:
    """Inverse of ``viewer_major``: [V, C * G, ...] -> [S, G, ...]."""
    v, cg = x.shape[:2]
    x = x.reshape(v, num_scenes, cg // num_scenes, *x.shape[2:])
    return torch.movedim(x, 0, 1).reshape(num_scenes * v, cg // num_scenes,
                                          *x.shape[3:])


def viewer_live(live: torch.Tensor, shape) -> torch.Tensor:
    """A per-viewer ([V]) or per-viewer-group ([V, G]) live mask broadcast
    to the [V, G, B] record shape."""
    live = torch.as_tensor(live, dtype=torch.bool)
    return torch.broadcast_to(live.reshape(live.shape + (1,) * (3 - live.ndim)),
                              tuple(shape))


def lookup_all_groups_multi(cache: CacheState, ids: torch.Tensor,
                            cfg: CacheConfig,
                            live: torch.Tensor | None = None):
    """Shared-cache lookup for V viewers: ids [V, G, B, k], live [V] (or
    [V, G]) bool.  Returns (hit [V,G,B], val [V,G,B,3], sidx, way, new
    cache).  LRU touches land in (slot, pixel) order; dead viewers probe
    without touching."""
    v = ids.shape[0]
    live_f = None
    if live is not None:
        live_f = slot_major(viewer_live(
            torch.as_tensor(live, device=ids.device), ids.shape[:3]))
    hit, val, sidx, way, cache = lookup_all_groups(cache, slot_major(ids),
                                                   cfg, live=live_f)
    return (slot_split(hit, v), slot_split(val, v), slot_split(sidx, v),
            slot_split(way, v), cache)


def insert_all_groups_multi(cache: CacheState, ids: torch.Tensor,
                            rgb: torch.Tensor, do_insert: torch.Tensor,
                            cfg: CacheConfig) -> CacheState:
    """Shared-cache insert for V viewers: ids [V, G, B, k], rgb [V, G, B, 3],
    do_insert [V, G, B].  Conflicts resolve by (slot, pixel) order;
    duplicate tags across viewers land once."""
    return insert_all_groups(cache, slot_major(ids), slot_major(rgb),
                             slot_major(do_insert), cfg)


def init_caches(num_scenes: int, num_groups: int, cfg: CacheConfig,
                device=None) -> CacheState:
    """Cold caches for ``num_scenes`` scenes: leaves [C, G, ...]."""
    return split_scenes(init_cache(num_scenes * num_groups, cfg, device),
                        num_scenes)


def flatten_scenes(cache: CacheState) -> CacheState:
    """[C, G, ...] scene caches as one [C * G, ...] cache of independent
    groups (views, no copy)."""
    return CacheState(*(x.flatten(0, 1) for x in
                        (cache.tags, cache.values, cache.age, cache.clock)))


def split_scenes(cache: CacheState, num_scenes: int) -> CacheState:
    """Inverse of ``flatten_scenes``."""
    return CacheState(*(x.unflatten(0, (num_scenes, -1)) for x in
                        (cache.tags, cache.values, cache.age, cache.clock)))
