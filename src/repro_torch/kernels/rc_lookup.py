"""The LuminCache probe kernel (``csrc/rc_lookup.cu``) and its plain version.

For every group's B k-id records: the set index (hash or bit
concatenation), the first of the set's W ways whose tag equals the record,
and that way's value.  The cache state is read only; the LRU touch is a
separate step (``radiance_cache.touch_all_groups``).
"""
from __future__ import annotations

import torch

from ..core import radiance_cache as rc
from . import LAUNCHES, build

_SIGNATURES = {'rc_lookup_launch': (7, 8, 1)}


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


def rc_lookup(tags: torch.Tensor, values: torch.Tensor, ids: torch.Tensor,
              cfg: rc.CacheConfig):
    """Probe every group's cache with its records (see ``rc_lookup_plain``)."""
    if ids.device.type == 'cpu':
        return rc_lookup_plain(tags, values, ids, cfg)
    if ids.device.type != 'cuda':
        raise ValueError(f'no rc_lookup kernel for device {ids.device}')
    g, s, w, k = tags.shape
    b = ids.shape[1]
    for name, x, dtype, shape in (('tags', tags, torch.int32, (g, s, w, k)),
                                  ('values', values, torch.float32, (g, s, w, 3)),
                                  ('ids', ids, torch.int32, (g, b, k))):
        if x.device != ids.device or x.dtype != dtype or \
                tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous {dtype} tensor of '
                             f'shape {shape} on {ids.device}, got {x.dtype} '
                             f'{tuple(x.shape)} on {x.device}')
    if k != cfg.k or s != cfg.n_sets or w != cfg.n_ways:
        raise ValueError(f'cache shape {tuple(tags.shape)} does not match {cfg}')
    dev = ids.device
    hit = torch.empty((g, b), dtype=torch.bool, device=dev)
    val = torch.empty((g, b, 3), dtype=torch.float32, device=dev)
    sidx = torch.empty((g, b), dtype=torch.int32, device=dev)
    way = torch.empty((g, b), dtype=torch.int32, device=dev)
    if g * b:
        bitconcat = cfg.index_mode == 'bitconcat'
        per_id = max(1, (s.bit_length() - 1) // k)
        lib = build.load('rc_lookup', _SIGNATURES)
        with torch.cuda.device(dev):
            code = lib.rc_lookup_launch(
                tags.data_ptr(), values.data_ptr(), ids.data_ptr(),
                hit.data_ptr(), val.data_ptr(), sidx.data_ptr(), way.data_ptr(),
                g, s, w, k, b, int(bitconcat), cfg.index_bits_shift, per_id,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, 'rc_lookup', code, 'rc_lookup kernel')
        LAUNCHES['rc_lookup'] += 1
    return hit, val, sidx, way
