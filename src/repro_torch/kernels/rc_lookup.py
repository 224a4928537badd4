"""The LuminCache probe kernel (``csrc/rc_lookup.cu``) and its plain versions.

``rc_lookup`` computes what the TPU kernel computes: for every group's B
k-id records, the set index (hash or bit concatenation), the first of the
set's W ways whose tag equals the record, and that way's value; the cache is
read only.  ``rc_probe`` is the whole probe of the port's frame and serving
tick: the same lookup over V viewers' records of each group, read where
they lie (viewer-major [V, G, B, k]) in the slot-major order of
``radiance_cache.slot_major``, followed by the LRU touch of
``radiance_cache.touch_all_groups``.  On the card both are one launch of
the same kernel; their plain versions are ``rc_lookup_plain`` and
``radiance_cache.lookup_all_groups_multi``.
"""
from __future__ import annotations

import torch

from ..core import radiance_cache as rc
from . import LAUNCHES, build

_SIGNATURES = {'rc_lookup_launch': (11, 10, 1)}
_MAX_K = 8


def _ptr(x: torch.Tensor | None) -> int:
    return 0 if x is None else x.data_ptr()


def rc_lookup_plain(tags: torch.Tensor, values: torch.Tensor, ids: torch.Tensor,
                    cfg: rc.CacheConfig):
    """tags [G,S,W,k] int32, values [G,S,W,3] float32, ids [G,B,k] int32 ->
    (hit [G,B] bool, value [G,B,3], set_idx [G,B] int32, way [G,B] int32)."""
    sidx = rc.set_index(ids, cfg)
    g = torch.arange(tags.shape[0], device=ids.device)[:, None]
    m = (tags[g, sidx] == ids[:, :, None, :]).all(dim=-1)       # [G, B, W]
    hit = m.any(dim=-1)
    way = torch.argmax(m.to(torch.int32), dim=-1)               # first match
    val = values[g, sidx, way]
    return hit, val, sidx.to(torch.int32), way.to(torch.int32)


def viewer_major_index(v: int, g: int, b: int, device=None) -> torch.Tensor:
    """The kernel's addressing in place of ``slot_major``: [G, V*B] int64,
    the flat index into viewer-major [V, G, B] records of record j of group
    g of the slot-major batch, ((j // B) * G + g) * B + j % B."""
    gi = torch.arange(g, device=device)[:, None]
    j = torch.arange(v * b, device=device)[None]
    return ((j // b) * g + gi) * b + j % b


def _launch(tags, values, ids, cfg, *, live=None, age=None, clock=None):
    """Check what the kernel reads and launch it over ids [V, G, B, k], or
    [G, B, k] for one viewer: lookup only (``age`` None; returns hit, value,
    set_idx, way) or fused (returns hit, value, way, the touched copy of
    ``age``, the new clock).  The records' outputs have the ids' leading
    shape."""
    dev = ids.device
    if dev.type != 'cuda':
        raise ValueError(f'no rc_lookup kernel for device {dev}')
    g, s, w, k = tags.shape
    rec = ids.shape[:-1]
    v, b = (rec[0] if ids.ndim == 4 else 1), rec[-1]
    if (s, w, k) != (cfg.n_sets, cfg.n_ways, cfg.k):
        raise ValueError(f'cache shape {tuple(tags.shape)} does not match {cfg}')
    if not 1 <= k <= _MAX_K or max(g * s * w, v * g * b) >= 2 ** 31:
        raise ValueError(f'the rc_lookup kernel takes k in 1..{_MAX_K} and fewer '
                         f'than 2**31 slots and records, got {cfg} over {g} '
                         f'groups and {v * g * b} records')
    checks = [('tags', tags, torch.int32, (g, s, w, k)),
              ('values', values, torch.float32, (g, s, w, 3)),
              ('ids', ids, torch.int32, (v, g, b, k)[4 - ids.ndim:])]
    if age is not None:
        checks += [('age', age, torch.int32, (g, s, w)),
                   ('clock', clock, torch.int32, (g,))]
        if live is not None:
            checks.append(('live', live, torch.bool,
                           (v, g) if live.ndim == 2 else (v,)))
    for name, x, dtype, shape in checks:
        if x.dtype != dtype or x.shape != shape or x.device != dev or \
                not x.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous {dtype} tensor of '
                             f'shape {shape} on {dev}, got {x.dtype} '
                             f'{tuple(x.shape)} on {x.device}')
    hit = torch.empty(rec, dtype=torch.bool, device=dev)
    val = torch.empty((*rec, 3), dtype=torch.float32, device=dev)
    way = torch.empty(rec, dtype=torch.int32, device=dev)
    fused = age is not None
    sidx = None if fused else torch.empty(rec, dtype=torch.int32, device=dev)
    if fused:
        age = age.clone()
        clock_out = torch.empty_like(clock)
    if v * g * b:
        lib = build.load('rc_lookup', _SIGNATURES)
        with torch.cuda.device(dev):
            code = lib.rc_lookup_launch(
                tags.data_ptr(), values.data_ptr(), ids.data_ptr(), _ptr(live),
                _ptr(age), _ptr(clock), _ptr(clock_out if fused else None),
                hit.data_ptr(), val.data_ptr(), _ptr(sidx), way.data_ptr(),
                g, v, b, s, w, k, int(cfg.index_mode == 'bitconcat'),
                cfg.index_bits_shift, max(1, (s.bit_length() - 1) // k),
                int(live is not None and live.ndim == 2),
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, 'rc_lookup', code, 'rc_lookup kernel')
        LAUNCHES['rc_lookup'] += 1
    elif fused:
        clock_out = clock.clone()
    if fused:
        return hit, val, way, age, clock_out
    return hit, val, sidx, way


def rc_lookup(tags: torch.Tensor, values: torch.Tensor, ids: torch.Tensor,
              cfg: rc.CacheConfig):
    """Probe every group's cache with its records (see ``rc_lookup_plain``)."""
    if ids.device.type == 'cpu':
        return rc_lookup_plain(tags, values, ids, cfg)
    return _launch(tags, values, ids, cfg)


def rc_probe(tags: torch.Tensor, values: torch.Tensor, age: torch.Tensor,
             clock: torch.Tensor, ids: torch.Tensor, cfg: rc.CacheConfig,
             live: torch.Tensor | None = None):
    """ids [V,G,B,k] int32 (or [G,B,k] for one viewer), live None, [V] or
    [V,G] bool -> (hit [V,G,B] bool, value [V,G,B,3], way [V,G,B] int32,
    age [G,S,W], clock [G]): the lookup of each group's slot-major batch
    (viewer 0's records first), then the LRU touch of its live hits, as
    ``radiance_cache.lookup_all_groups_multi`` evolves the cache (the plain
    version, which the CPU route runs).  ``age`` and ``clock`` come back as
    new tensors.  On the card one launch reads the viewer-major ids in place
    and touches a copy of ``age``."""
    if ids.device.type == 'cpu':
        one = ids.ndim == 3
        hit, val, _, way, cache = rc.lookup_all_groups_multi(
            rc.CacheState(tags, values, age, clock), ids[None] if one else ids,
            cfg, live=live)
        if one:
            hit, val, way = hit[0], val[0], way[0]
        return hit, val, way.to(torch.int32), cache.age, cache.clock
    if live is not None:
        live = torch.as_tensor(live, dtype=torch.bool,
                               device=ids.device).contiguous()
    return _launch(tags, values, ids, cfg, live=live, age=age, clock=clock)
