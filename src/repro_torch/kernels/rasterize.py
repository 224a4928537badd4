"""The tile rasterizer kernel (``csrc/rasterize.cu``) and its plain version.

One block = one 16x16-pixel tile, one thread per pixel.  The tile's
depth-sorted Gaussian features are walked in chunks of ``chunk``; each
pixel integrates front to back in the per-Gaussian order of the reference,
and a chunk-level early exit stops the tile as soon as every pixel is done
(dead, past its transmittance floor, or — in prefix mode — holding a full
alpha-record) or the walk passes the tile's chunk cap ``ncap``.

Modes (see ``ops``):
  * full    — baseline rasterization;
  * prefix  — ``stop_at_k``: stop each pixel once its k-record fills
              (radiance-cache phase A);
  * resume  — continue cache-miss pixels from their saved state, gated by
              per-pixel ``start_iter`` and ``live`` (phase B).
``rasterize_compact`` is the miss-compacted resume: the P lanes of a block
come from different source tiles, each with its own pixel center, source
tile and chunk cap; ``rasterize_compact_home`` is the same kernel over the
compacted lanes of a [T, P] frame addressed through their home pixels, as
phase B calls it (only live lanes are read and written).  Each lane walks
on its own, and the lane tile's trip count is recovered from the lanes'
stops (``compact_chunks_plain`` mirrors it).  ``rasterize_slots`` is the
full or prefix pass of the multi-viewer serving tick: one tile of all S
slots, whose reported trip count is shared by the slots (the loop runs
until no lane of any slot remains).

The kernel's record count counts every contribution (``rec_cnt`` may pass
k); only the first k ids are recorded.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.gaussians import ALPHA_MAX, ALPHA_SIGNIFICANT, TRANSMITTANCE_EPS
from ..core.rasterize import P, pixel_centers
from ..core.tiling import TILE
from . import LAUNCHES, build

_SIGNATURES = {'rasterize_launch': (20, 6, 1),
               'rasterize_slots_launch': (19, 7, 1),
               'rasterize_compact_launch': (23, 4, 1),
               'rasterize_compact_home_launch': (20, 6, 1)}


@dataclasses.dataclass(frozen=True)
class RasterState:
    """Per-pixel kernel state: inputs (phase init) and outputs alike.  The
    slot-batched form has [S, T, P, ...] leaves and the same chunks [T, 1]."""

    acc: torch.Tensor        # [T, P, 3]
    trans: torch.Tensor      # [T, P]
    record: torch.Tensor     # [T, P, k]
    rec_cnt: torch.Tensor    # [T, P]
    n_sig: torch.Tensor      # [T, P]
    n_iter: torch.Tensor     # [T, P]
    iter_at_k: torch.Tensor  # [T, P]
    chunks: torch.Tensor     # [T, 1] chunks actually processed


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _walk(feat_at, px, py, state, start, live, c0, cond, *, k_record, chunk,
          stop_at_k):
    """Per-tile chunk loops of the kernel, run for all tiles at once.

    Tile ``t`` starts at chunk ``c0[t]`` and keeps going while ``cond(c,
    state)`` holds for it; once false it stops for good, exactly like the
    kernel's ``while``.  ``feat_at(rows, pos)`` returns the features
    (mean2d [R,P,2], conic [R,P,3], color [R,P,3], opacity [R,P], ids [R,P])
    of list position ``pos`` for the given rows.  ``state`` is updated in
    place; returns chunks [T, 1].
    """
    acc, trans, rec, cnt, nsig, niter, itk = state
    dev = trans.device
    t = trans.shape[0]
    slots = torch.arange(k_record, dtype=torch.int32, device=dev)
    chunks = torch.zeros((t,), dtype=torch.int32, device=dev)
    alive = torch.ones((t,), dtype=torch.bool, device=dev)
    c = int(c0.min()) if t else 0
    while True:
        started = c >= c0
        alive = alive & (~started | cond(c))
        if not bool(alive.any()):
            break
        rows = (alive & started).nonzero().squeeze(1)
        if rows.numel():
            r_px, r_py, r_start, r_live = px[rows], py[rows], start[rows], live[rows]
            r_acc, r_trans, r_rec = acc[rows], trans[rows], rec[rows]
            r_cnt, r_nsig, r_niter, r_itk = cnt[rows], nsig[rows], niter[rows], itk[rows]
            for pos in range(c * chunk, (c + 1) * chunk):
                gm, gc, gcol, gop, gid = feat_at(rows, pos)
                dx = r_px - gm[..., 0]
                dy = r_py - gm[..., 1]
                power = (-0.5 * (gc[..., 0] * dx * dx + gc[..., 2] * dy * dy)
                         - gc[..., 1] * dx * dy)
                alpha = torch.clamp(gop * torch.exp(power), max=ALPHA_MAX)
                valid = (power <= 0.0) & (gid >= 0)
                allowed = (pos >= r_start) & r_live
                active = r_trans > TRANSMITTANCE_EPS
                sig = (alpha > ALPHA_SIGNIFICANT) & valid & allowed
                examined = active & (gid >= 0) & allowed
                if stop_at_k:
                    sig = sig & (r_cnt < k_record)
                    examined = examined & (r_cnt < k_record)
                contrib = sig & active

                w = torch.where(contrib, r_trans * alpha, 0.0)
                r_acc = r_acc + w[..., None] * gcol
                r_trans = torch.where(contrib, r_trans * (1.0 - alpha), r_trans)
                put = (slots == r_cnt[..., None]) & (contrib & (r_cnt < k_record))[..., None]
                r_rec = torch.where(put, gid[..., None], r_rec)
                new_cnt = r_cnt + contrib.int()
                r_itk = torch.where((new_cnt >= k_record) & (r_cnt < k_record)
                                    & contrib, pos + 1, r_itk)
                r_cnt = new_cnt
                r_nsig = r_nsig + contrib.int()
                r_niter = r_niter + examined.int()
            acc[rows], trans[rows], rec[rows] = r_acc, r_trans, r_rec
            cnt[rows], nsig[rows], niter[rows], itk[rows] = r_cnt, r_nsig, r_niter, r_itk
            chunks[rows] += 1
        c += 1
    return chunks[:, None]


# The band cull of ``rasterize_kernel`` (its source note proves it
# conservative): each warp of a tile's block (a band of 16x2 pixels) walks
# only the Gaussians of a chunk that may be significant at one of its pixel
# centres; a culled Gaussian changes nothing but n_iter.  These are the
# constants of that note (steps 2, 3, 3d and 3e).
_CULL_OP_FACTOR = 1.0 + 2.0 ** -21
_CULL_RHO_MAX = 1.0 - 2.0 ** -11
_CULL_ETA = 2.0 ** -20
_CULL_BETA = 2.0 ** -9
_CULL_PAD = 1.0 + 2.0 ** -20
BAND_ROWS = 2   # pixel rows of a warp's band


def tile_cull_plain(mean2d, conic, opacity, ids, *,
                    tiles_x: int) -> torch.Tensor:
    """The kernel's cull predicate, written with tensor ops in the same
    double-precision expressions: may Gaussian k of tile t be significant at
    a pixel centre of band j (rows ``BAND_ROWS * j`` onwards) of the tile?

    Features [..., T, K, ...] as in ``rasterize``.  Returns keep
    [..., T, K, 16 // BAND_ROWS] bool; a False entry is a culled pair.  Used
    by the tests and by ``chip_smoke.py``'s counters, not by the wrappers.
    """
    f64 = torch.float64
    dev = ids.device
    t = ids.shape[-2]
    k_sig = float(torch.tensor(ALPHA_SIGNIFICANT, dtype=torch.float32))
    mx, my = mean2d[..., 0].to(f64), mean2d[..., 1].to(f64)
    a, b, c = (conic[..., i].to(f64) for i in range(3))
    op = opacity.to(f64)
    culled = (ids < 0) | ~(op * _CULL_OP_FACTOR > k_sig)
    finite = (torch.isfinite(mean2d).all(-1) & torch.isfinite(conic).all(-1))
    test = (~culled & (op <= 1.0) & finite & (a > 0.0) & (c > 0.0)
            & (b * b <= _CULL_RHO_MAX * _CULL_RHO_MAX * (a * c)))
    kept = ~culled & ~test
    r2 = 2.0 * (torch.log(op / k_sig) + _CULL_ETA) / (1.0 - _CULL_BETA) * _CULL_PAD
    nbc, nba = -b / c, -b / a
    tix = torch.arange(t, device=dev)
    x_lo = (tix % tiles_x * TILE).to(f64)[:, None] + 0.5

    def q(u, v):
        return a * u * u + 2.0 * b * u * v + c * v * v

    def clamp(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    bands = []
    for j in range(TILE // BAND_ROWS):
        y_lo = (tix // tiles_x * TILE + BAND_ROWS * j).to(f64)[:, None] + 0.5
        u0, v0 = x_lo - mx, y_lo - my
        u1, v1 = u0 + (TILE - 1), v0 + (BAND_ROWS - 1)
        inside = (u0 <= 0.0) & (u1 >= 0.0) & (v0 <= 0.0) & (v1 >= 0.0)
        qmin = torch.minimum(
            torch.minimum(q(u0, clamp(nbc * u0, v0, v1)),
                          q(u1, clamp(nbc * u1, v0, v1))),
            torch.minimum(q(clamp(nba * v0, u0, u1), v0),
                          q(clamp(nba * v1, u0, u1), v1)))
        bands.append(kept | (test & (inside | ~(qmin >= r2))))
    return torch.stack(bands, -1)


def _init_state(acc0, trans0, rec0, cnt0, k_total):
    zeros = torch.zeros(trans0.shape, dtype=torch.int32, device=trans0.device)
    return [acc0.clone().float(), trans0.clone().float(), rec0.clone(),
            cnt0.clone(), zeros, zeros.clone(), torch.full_like(zeros, k_total)]


def rasterize_plain(mean2d, conic, color, opacity, ids, acc0, trans0, rec0,
                    cnt0, start_iter, live, ncap, *, tiles_x: int,
                    k_record: int = 5, chunk: int = 64,
                    stop_at_k: bool = False) -> RasterState:
    """The rasterize kernel written with tensor ops (same arguments)."""
    t, k_total = ids.shape
    px, py = pixel_centers(tiles_x, t, ids.device)
    live_b = live != 0
    nc = torch.clamp(ncap.reshape(t), max=k_total // chunk)
    start_eff = torch.where(live_b, start_iter, k_total)
    c0 = torch.minimum(start_eff.amin(1) // chunk, nc)
    state = _init_state(acc0, trans0, rec0, cnt0, k_total)

    def cond(c):
        trans, cnt = state[1], state[3]
        done = ~live_b | (trans <= TRANSMITTANCE_EPS)
        if stop_at_k:
            done = done | (cnt >= k_record)
        return (c < nc) & ~done.all(1)

    def feat_at(rows, pos):
        return (mean2d[rows, pos][:, None], conic[rows, pos][:, None],
                color[rows, pos][:, None], opacity[rows, pos][:, None],
                ids[rows, pos][:, None])

    chunks = _walk(feat_at, px, py, state, start_iter, live_b, c0, cond,
                   k_record=k_record, chunk=chunk, stop_at_k=stop_at_k)
    return RasterState(*state, chunks=chunks)


def rasterize_compact_plain(mean2d, conic, color, opacity, ids, px, py, src,
                            ncap, acc0, trans0, rec0, cnt0, start_iter, live,
                            *, k_record: int = 5,
                            chunk: int = 64) -> RasterState:
    """The compacted-resume kernel written with tensor ops (same arguments)."""
    k_total = ids.shape[1]
    nc_total = k_total // chunk
    live_b = live != 0
    start_eff = torch.where(live_b, start_iter, k_total)
    c0 = torch.clamp(start_eff.amin(1) // chunk, max=nc_total)
    state = _init_state(acc0, trans0, rec0, cnt0, k_total)
    src = src.long()

    def cond(c):
        left = live_b & (state[1] > TRANSMITTANCE_EPS) & (c < ncap)
        return (c < nc_total) & left.any(1)

    def feat_at(rows, pos):
        s = src[rows]
        return mean2d[s, pos], conic[s, pos], color[s, pos], opacity[s, pos], ids[s, pos]

    chunks = _walk(feat_at, px, py, state, start_iter, live_b, c0, cond,
                   k_record=k_record, chunk=chunk, stop_at_k=False)
    return RasterState(*state, chunks=chunks)


def compact_lane_stops_plain(mean2d, conic, color, opacity, ids, px, py, src,
                             ncap, acc0, trans0, rec0, cnt0, start_iter, live,
                             *, k_record: int = 5, chunk: int = 64):
    """The pieces of ``rasterize_compact_kernel``'s decoupled trip count
    (its source note proves it equal to the coupled loop's), from the same
    arguments as ``rasterize_compact``.

    Each lane is walked alone from its own start chunk, as a thread of the
    kernel walks it, until its "remaining" test (transmittance above its
    floor, chunk below ``min(ncap, K / chunk)``) fails.  Returns (stop
    [CT, P], the chunk at which that test first fails for a live lane whose
    transmittance starts above its floor and 0 for every other lane; start
    [CT, P], each lane's own start chunk; c0 [CT], the lane tile's first
    chunk, clamped to K / chunk)."""
    k_total = ids.shape[1]
    nc_total = k_total // chunk
    ct = src.shape[0]
    n = ct * P
    live_b = live != 0
    going = live_b & (trans0 > TRANSMITTANCE_EPS)
    start = start_iter // chunk
    cap = torch.clamp(ncap, max=nc_total).reshape(n)
    first = torch.where(going, start, nc_total).reshape(n)
    state = _init_state(acc0.reshape(n, 1, 3), trans0.reshape(n, 1),
                        rec0.reshape(n, 1, k_record), cnt0.reshape(n, 1),
                        k_total)
    src_l = src.reshape(n).long()

    def cond(c):
        return (c < cap) & (state[1][:, 0] > TRANSMITTANCE_EPS)

    def feat_at(rows, pos):
        s = src_l[rows]
        return (mean2d[s, pos][:, None], conic[s, pos][:, None],
                color[s, pos][:, None], opacity[s, pos][:, None],
                ids[s, pos][:, None])

    walked = _walk(feat_at, px.reshape(n, 1), py.reshape(n, 1), state,
                   start_iter.reshape(n, 1), live_b.reshape(n, 1), first, cond,
                   k_record=k_record, chunk=chunk, stop_at_k=False)
    stop = torch.where(going, torch.minimum(start + walked.reshape(ct, P),
                                            cap.reshape(ct, P)), 0)
    start_eff = torch.where(live_b, start_iter, k_total)
    c0 = torch.clamp(start_eff.amin(1) // chunk, max=nc_total)
    return stop, start, c0


def compact_chunks_plain(*args, k_record: int = 5,
                         chunk: int = 64) -> torch.Tensor:
    """The kernel's per-lane-tile trip count, chunks [CT, 1]: the largest
    stop chunk of ``compact_lane_stops_plain`` minus the tile's c0, floored
    at 0.  Used by the tests and by ``chip_smoke.py``, not by the wrappers."""
    stop, _, c0 = compact_lane_stops_plain(*args, k_record=k_record,
                                           chunk=chunk)
    return torch.clamp(stop.amax(1) - c0, min=0).to(torch.int32)[:, None]


def compact_lanes(ncap, acc0, trans0, rec0, cnt0, itk0, home, n_live, *,
                  tiles_x: int, t_img: int) -> tuple:
    """The explicit lanes that a home-indexed call (``rasterize_compact_home``
    arguments) stands for, in the compacted order: px, py, src, ncap, acc0,
    trans0, rec0, cnt0, start_iter and live [T, P, ...], as
    ``rasterize_compact`` takes them."""
    t = trans0.shape[0]
    n = t * P
    home = home.long()
    tix = home // P
    pix = home % P
    tim = tix % t_img
    px = ((tim % tiles_x) * TILE + pix % TILE).float() + 0.5
    py = ((tim // tiles_x) * TILE + pix // TILE).float() + 0.5
    live = (torch.arange(n, device=home.device) < n_live).to(torch.int32)

    def gather(x):
        return x.reshape(n, *x.shape[2:])[home].reshape(t, P, *x.shape[2:])

    return (px.reshape(t, P), py.reshape(t, P),
            tix.to(torch.int32).reshape(t, P), ncap[tix].reshape(t, P),
            gather(acc0), gather(trans0), gather(rec0), gather(cnt0),
            gather(itk0), live.reshape(t, P))


def rasterize_compact_home_plain(mean2d, conic, color, opacity, ids, ncap,
                                 acc0, trans0, rec0, cnt0, nsig0, niter0,
                                 itk0, home, n_live, *, tiles_x: int,
                                 t_img: int, k_record: int = 5,
                                 chunk: int = 64) -> RasterState:
    """The home-indexed resume written with tensor ops (same arguments as
    ``rasterize_compact_home``): gather the lanes into the compacted order
    (``compact_lanes``), ``rasterize_compact_plain``, scatter back, and
    combine with phase A's counts."""
    lanes = compact_lanes(ncap, acc0, trans0, rec0, cnt0, itk0, home, n_live,
                          tiles_x=tiles_x, t_img=t_img)
    if bool(((lanes[7] < k_record) & (lanes[9] != 0)).any()):
        raise ValueError('a live lane of rasterize_compact_home must hold a '
                         'full record (cnt0 >= k_record)')
    st = rasterize_compact_plain(mean2d, conic, color, opacity, ids, *lanes,
                                 k_record=k_record, chunk=chunk)
    home = home.long()

    def scatter(x):
        flat = x.reshape(home.numel(), *x.shape[2:])
        out = torch.empty_like(flat)
        out[home] = flat
        return out.reshape(x.shape)

    return RasterState(acc=scatter(st.acc), trans=scatter(st.trans),
                       record=scatter(st.record), rec_cnt=scatter(st.rec_cnt),
                       n_sig=nsig0 + scatter(st.n_sig),
                       n_iter=niter0 + scatter(st.n_iter),
                       iter_at_k=torch.minimum(itk0, scatter(st.iter_at_k)),
                       chunks=st.chunks)


def rasterize_slots_plain(mean2d, conic, color, opacity, ids, acc0, trans0,
                          rec0, cnt0, live, ncap, *, tiles_x: int,
                          k_record: int = 5, chunk: int = 64,
                          stop_at_k: bool = False) -> RasterState:
    """The slot-batched kernel written with tensor ops (same arguments): the
    S slots' lanes of a tile are one row of S*P lanes, and the row's loop
    runs while any lane of any slot remains, as on the TPU.  Every lane
    starts at chunk 0.  Returns [S, T, ...] state and chunks [T, 1], the
    row's trip count."""
    s, t, k_total = ids.shape
    dev = ids.device
    n = s * P

    def lanes(x):        # [S, T, P, ...] -> [T, S*P, ...]
        return x.transpose(0, 1).reshape(t, n, *x.shape[3:])

    px, py = pixel_centers(tiles_x, t, dev)
    px, py = px.repeat(1, s), py.repeat(1, s)
    live_b = lanes(live) != 0
    nc_total = k_total // chunk
    ncap_l = torch.clamp(ncap, max=nc_total).T.repeat_interleave(P, dim=1)
    start = torch.zeros((t, n), dtype=torch.int32, device=dev)
    c0 = torch.where(live_b.any(1), 0, nc_total)
    state = _init_state(lanes(acc0), lanes(trans0), lanes(rec0), lanes(cnt0),
                        k_total)

    def cond(c):
        left = live_b & (state[1] > TRANSMITTANCE_EPS) & (c < ncap_l)
        if stop_at_k:
            left = left & (state[3] < k_record)
        return (c < nc_total) & left.any(1)

    def feat_at(rows, pos):     # each slot's feature, repeated over its lanes
        return tuple(x[:, rows, pos].transpose(0, 1).repeat_interleave(P, dim=1)
                     for x in (mean2d, conic, color, opacity, ids))

    chunks = _walk(feat_at, px, py, state, start, live_b, c0, cond,
                   k_record=k_record, chunk=chunk, stop_at_k=stop_at_k)
    out = [x.reshape(t, s, P, *x.shape[2:]).transpose(0, 1).contiguous()
           for x in state]
    return RasterState(*out, chunks=chunks)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def _check(expect: dict, device: torch.device) -> None:
    for name, (x, dtype, shape) in expect.items():
        if x.device != device:
            raise ValueError(f'{name} lies on {x.device}, expected {device}')
        if x.dtype != dtype:
            raise TypeError(f'{name} has dtype {x.dtype}, expected {dtype}')
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(x.shape)}, expected {tuple(shape)}')
        if not x.is_contiguous():
            raise ValueError(f'{name} is not contiguous')


# rasterize_compact_kernel takes 4 Gaussians of a list at once, in 16-byte
# loads
_COMPACT_BATCH = 4


def _check_compact(chunk: int, features) -> None:
    if chunk % _COMPACT_BATCH:
        raise ValueError(f'the rasterize_compact kernel needs chunk={chunk} '
                         f'to be a multiple of {_COMPACT_BATCH}')
    for x in features:
        if x.data_ptr() % 16:
            raise ValueError('the rasterize_compact kernel needs 16-byte '
                             'aligned feature arrays')


def _outputs(n: int, k_record: int, device) -> list:
    f32, i32 = torch.float32, torch.int32
    return [torch.empty((n, P, 3), dtype=f32, device=device),
            torch.empty((n, P), dtype=f32, device=device),
            torch.empty((n, P, k_record), dtype=i32, device=device),
            *[torch.empty((n, P), dtype=i32, device=device) for _ in range(4)],
            torch.zeros((n, 1), dtype=i32, device=device)]   # atomicMax target


def _state_spec(n: int, k_record: int, acc0, trans0, rec0, cnt0,
                start_iter, live) -> dict:
    f32, i32 = torch.float32, torch.int32
    return {'acc0': (acc0, f32, (n, P, 3)), 'trans0': (trans0, f32, (n, P)),
            'rec0': (rec0, i32, (n, P, k_record)), 'cnt0': (cnt0, i32, (n, P)),
            'start_iter': (start_iter, i32, (n, P)),
            'live': (live, i32, (n, P))}


def _feature_spec(mean2d, conic, color, opacity, ids) -> dict:
    t, k = ids.shape
    f32 = torch.float32
    return {'mean2d': (mean2d, f32, (t, k, 2)), 'conic': (conic, f32, (t, k, 3)),
            'color': (color, f32, (t, k, 3)), 'opacity': (opacity, f32, (t, k)),
            'ids': (ids, torch.int32, (t, k))}


def rasterize(mean2d, conic, color, opacity, ids, acc0, trans0, rec0, cnt0,
              start_iter, live, ncap, *, tiles_x: int, k_record: int = 5,
              chunk: int = 64, stop_at_k: bool = False) -> RasterState:
    """Rasterize [T, K] feature lists into [T, P] pixel state.

    Features: mean2d [T,K,2], conic [T,K,3], color [T,K,3], opacity [T,K]
    float32 and ids [T,K] int32, K a multiple of ``chunk``.  State: acc0
    [T,P,3], trans0 [T,P] float32; rec0 [T,P,k], cnt0, start_iter, live
    [T,P] int32.  ``ncap`` [T] int32 caps the chunks each tile may walk.
    """
    t, k_total = ids.shape
    if k_total % chunk:
        raise ValueError(f'K={k_total} is not a multiple of chunk={chunk}')
    if ids.device.type == 'cpu':
        return rasterize_plain(mean2d, conic, color, opacity, ids, acc0, trans0,
                               rec0, cnt0, start_iter, live, ncap,
                               tiles_x=tiles_x, k_record=k_record, chunk=chunk,
                               stop_at_k=stop_at_k)
    if ids.device.type != 'cuda':
        raise ValueError(f'no rasterize kernel for device {ids.device}')
    _check({**_feature_spec(mean2d, conic, color, opacity, ids),
            **_state_spec(t, k_record, acc0, trans0, rec0, cnt0,
                          start_iter, live),
            'ncap': (ncap, torch.int32, (t,))}, ids.device)
    out = _outputs(t, k_record, ids.device)
    if t:
        lib = build.load('rasterize', _SIGNATURES)
        with torch.cuda.device(ids.device):
            code = lib.rasterize_launch(
                *[x.data_ptr() for x in (mean2d, conic, color, opacity, ids,
                                         acc0, trans0, rec0, cnt0, start_iter,
                                         live, ncap)],
                *[x.data_ptr() for x in out],
                t, k_total, tiles_x, k_record, chunk, int(stop_at_k),
                torch.cuda.current_stream(ids.device).cuda_stream)
        build.check(lib, 'rasterize', code, 'rasterize kernel')
        LAUNCHES['rasterize'] += 1
    return RasterState(*out)


def rasterize_slots(mean2d, conic, color, opacity, ids, acc0, trans0, rec0,
                    cnt0, live, ncap, *, tiles_x: int, k_record: int = 5,
                    chunk: int = 64, stop_at_k: bool = False) -> RasterState:
    """Rasterize one tile of all S serving slots per tile position.

    Features [S, T, K, ...], state [S, T, P, ...] and ``live`` [S, T, P]
    int32 as in ``rasterize`` (no ``start_iter``: every lane starts at chunk
    0); ``ncap`` [S, T] int32.  Returns [S, T, P, ...] state and chunks
    [T, 1], the trip count shared by the slots of each tile.
    """
    s, t, k_total = ids.shape
    if k_total % chunk:
        raise ValueError(f'K={k_total} is not a multiple of chunk={chunk}')
    if ids.device.type == 'cpu':
        return rasterize_slots_plain(mean2d, conic, color, opacity, ids, acc0,
                                     trans0, rec0, cnt0, live, ncap,
                                     tiles_x=tiles_x, k_record=k_record,
                                     chunk=chunk, stop_at_k=stop_at_k)
    if ids.device.type != 'cuda':
        raise ValueError(f'no rasterize_slots kernel for device {ids.device}')
    f32, i32 = torch.float32, torch.int32
    _check({'mean2d': (mean2d, f32, (s, t, k_total, 2)),
            'conic': (conic, f32, (s, t, k_total, 3)),
            'color': (color, f32, (s, t, k_total, 3)),
            'opacity': (opacity, f32, (s, t, k_total)),
            'ids': (ids, i32, (s, t, k_total)),
            'acc0': (acc0, f32, (s, t, P, 3)), 'trans0': (trans0, f32, (s, t, P)),
            'rec0': (rec0, i32, (s, t, P, k_record)),
            'cnt0': (cnt0, i32, (s, t, P)), 'live': (live, i32, (s, t, P)),
            'ncap': (ncap, i32, (s, t))}, ids.device)
    out = [x.view(s, t, *x.shape[1:]) for x in _outputs(s * t, k_record,
                                                          ids.device)[:-1]]
    chunks = torch.zeros((t, 1), dtype=i32, device=ids.device)  # atomicMax target
    if s * t:
        lib = build.load('rasterize', _SIGNATURES)
        with torch.cuda.device(ids.device):
            code = lib.rasterize_slots_launch(
                *[x.data_ptr() for x in (mean2d, conic, color, opacity, ids,
                                         acc0, trans0, rec0, cnt0, live, ncap)],
                *[x.data_ptr() for x in out], chunks.data_ptr(),
                t, s, k_total, tiles_x, k_record, chunk, int(stop_at_k),
                torch.cuda.current_stream(ids.device).cuda_stream)
        build.check(lib, 'rasterize', code, 'rasterize_slots kernel')
        LAUNCHES['rasterize_slots'] += 1
    return RasterState(*out, chunks=chunks)


def rasterize_compact(mean2d, conic, color, opacity, ids, px, py, src, ncap,
                      acc0, trans0, rec0, cnt0, start_iter, live, *,
                      k_record: int = 5, chunk: int = 64) -> RasterState:
    """Resume integration over CT compacted tiles of lanes (the JAX
    package's contract): features are the full [T, K, ...] lists; px/py
    [CT,P] float32, src/ncap [CT,P] int32 and the state tensors are
    [CT, P, ...] (see ``rasterize``).  A lane's ``ncap`` must not lie below
    its source tile's ``chunk_caps`` (past it every id is -1): the kernel
    walks each lane only up to its own cap, which equals the lane tile's
    common loop under that condition.  Every lane's state is written out."""
    k_total = ids.shape[1]
    ct = src.shape[0]
    if k_total % chunk:
        raise ValueError(f'K={k_total} is not a multiple of chunk={chunk}')
    if ids.device.type == 'cpu':
        return rasterize_compact_plain(mean2d, conic, color, opacity, ids, px,
                                       py, src, ncap, acc0, trans0, rec0, cnt0,
                                       start_iter, live, k_record=k_record,
                                       chunk=chunk)
    if ids.device.type != 'cuda':
        raise ValueError(f'no rasterize_compact kernel for device {ids.device}')
    f32, i32 = torch.float32, torch.int32
    _check({**_feature_spec(mean2d, conic, color, opacity, ids),
            'px': (px, f32, (ct, P)), 'py': (py, f32, (ct, P)),
            'src': (src, i32, (ct, P)), 'ncap': (ncap, i32, (ct, P)),
            **_state_spec(ct, k_record, acc0, trans0, rec0, cnt0,
                          start_iter, live)}, ids.device)
    _check_compact(chunk, (mean2d, conic, color, opacity, ids))
    out = _outputs(ct, k_record, ids.device)
    if ct:
        lib = build.load('rasterize', _SIGNATURES)
        with torch.cuda.device(ids.device):
            code = lib.rasterize_compact_launch(
                *[x.data_ptr() for x in (mean2d, conic, color, opacity, ids, px,
                                         py, src, ncap, acc0, trans0, rec0,
                                         cnt0, start_iter, live)],
                *[x.data_ptr() for x in out],
                ct, k_total, k_record, chunk,
                torch.cuda.current_stream(ids.device).cuda_stream)
        build.check(lib, 'rasterize', code, 'rasterize_compact kernel')
        LAUNCHES['rasterize_compact'] += 1
    return RasterState(*out)


def rasterize_compact_home(mean2d, conic, color, opacity, ids, ncap, acc0,
                           trans0, rec0, cnt0, nsig0, niter0, itk0, home,
                           n_live, *, tiles_x: int, t_img: int,
                           k_record: int = 5, chunk: int = 64) -> RasterState:
    """Phase B over the miss-compacted lanes of a [T, P] frame, addressed
    through their home pixels.

    ``home`` [T * P] int32 lists the flat home index of each lane of the
    compacted order, live lanes first; the first ``n_live`` (a 0-dim int32
    tensor, read on the device) are live.  Lane tile j is lanes 256 j ..
    256 j + 255 of that order, as in ``rasterize_compact``.  Each live lane
    starts at phase A's ``itk0`` from phase A's state (acc0, trans0, rec0,
    cnt0 [T, P, ...]) with its source tile's cap from ``ncap`` [T]; pixel
    coordinates repeat every ``t_img`` tiles.  As phase B's lanes do, every
    live lane holds a full record (``cnt0 >= k_record``): its record and
    iter_at_k then do not change, and come back as phase A's own ``rec0``
    and ``itk0``.  Returns [T, P, ...] state combined with phase A's (n_sig
    and n_iter added; every other lane keeps phase A's) and chunks [T, 1]
    per lane tile.
    """
    t, k_total = ids.shape
    if k_total % chunk:
        raise ValueError(f'K={k_total} is not a multiple of chunk={chunk}')
    if ids.device.type == 'cpu':
        return rasterize_compact_home_plain(
            mean2d, conic, color, opacity, ids, ncap, acc0, trans0, rec0,
            cnt0, nsig0, niter0, itk0, home, n_live, tiles_x=tiles_x,
            t_img=t_img, k_record=k_record, chunk=chunk)
    if ids.device.type != 'cuda':
        raise ValueError(f'no rasterize_compact kernel for device {ids.device}')
    i32 = torch.int32
    _check({**_feature_spec(mean2d, conic, color, opacity, ids),
            'ncap': (ncap, i32, (t,)),
            'acc0': (acc0, torch.float32, (t, P, 3)),
            'trans0': (trans0, torch.float32, (t, P)),
            'rec0': (rec0, i32, (t, P, k_record)),
            **{name: (x, i32, (t, P)) for name, x in (
                ('cnt0', cnt0), ('nsig0', nsig0), ('niter0', niter0),
                ('itk0', itk0))},
            'home': (home, i32, (t * P,)),
            'n_live': (n_live, i32, ())}, ids.device)
    _check_compact(chunk, (mean2d, conic, color, opacity, ids))
    # lanes that are not live keep phase A's state: start from a copy
    out = [x.clone() for x in (acc0, trans0, cnt0, nsig0, niter0)]
    chunks = torch.zeros((t, 1), dtype=i32, device=ids.device)  # atomicMax target
    if t:
        lib = build.load('rasterize', _SIGNATURES)
        with torch.cuda.device(ids.device):
            code = lib.rasterize_compact_home_launch(
                *[x.data_ptr() for x in (mean2d, conic, color, opacity, ids,
                                         ncap, acc0, trans0, cnt0, nsig0,
                                         niter0, itk0, home, n_live, *out,
                                         chunks)],
                t, k_total, tiles_x, t_img, k_record, chunk,
                torch.cuda.current_stream(ids.device).cuda_stream)
        build.check(lib, 'rasterize', code, 'rasterize_compact kernel')
        LAUNCHES['rasterize_compact'] += 1
    acc, trans, cnt, nsig, niter = out
    return RasterState(acc=acc, trans=trans, record=rec0, rec_cnt=cnt,
                       n_sig=nsig, n_iter=niter, iter_at_k=itk0, chunks=chunks)
