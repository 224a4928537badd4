"""LuminSys — the single-viewer frame pipeline (paper Sec. 3.3).

Combines the three stages with both optimizations:

  pose history --> predict pose --> [Projection + Sorting] at predicted pose
       (speculative, once per sharing window, expanded viewport)
  every frame  --> sorting-shared prep (refresh geometry + SH colors)
               --> Rasterization with alpha-record extraction
               --> Radiance-Cache lookup: hits take the cached RGB and
                   terminate early; misses complete integration and insert.

State is split along the sharing axis of a serving fleet:

  * ``SceneShared``   — what every viewer of one scene shares: one radiance
    cache plus a pool of ``SortShared`` entries (one entry here);
  * ``ViewerPrivate`` — what stays per viewer: previous pose, frame counter,
    pose-cell id, pool index;
  * ``ViewerState``   — the single-viewer composition carried by
    ``render_step`` / ``LuminSys``.

A frame is two phases: ``sort_phase`` (pose prediction + speculative
Projection/Sorting, once per sharing window) and ``shade_phase`` (prep +
rasterization + radiance cache, every frame).  ``render_step`` runs the
sort when ``frame_idx % window == 0``.  Functions return new state and
leave their inputs untouched.

The multi-viewer serving tick (``repro_torch.serve.stepper``) holds the
same two classes in a scene-major and a slot-major form (``init_fleet``):
S = C * V slots over C scenes, slot i in scene i // V.  It schedules the
sorts itself and advances every slot through ``batched_shade_phase``,
whose cache stages run scene-major, so the viewers of a scene probe and
fill its one cache in (slot, pixel) order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import radiance_cache as rc
from .camera import Camera, camera_at, stack_cameras
from .gaussians import GaussianScene
from .groups import num_groups, regroup, regroup_slots, ungroup, ungroup_slots
from .projection import project
from .rasterize import RasterAux, assemble_image, rasterize_tiles
from .s2 import (SortShared, empty_sort_shared, predict_window_pose,
                 shared_features, speculative_sort)
from .sorting import sort_scene
from .tiling import TileFeatures, gather_tile_features, tile_grid
from ..device import check_on, resolve_device

BACKENDS = ('reference', 'kernel')


@dataclasses.dataclass(frozen=True)
class LuminaConfig:
    """Algorithm configuration (paper defaults: window=6, margin=4, k=5).

    ``backend`` selects the shade implementation: ``'reference'`` is the
    plain rasterizer + functional cache (the oracle); ``'kernel'`` routes
    shading through the rasterize and lookup kernels (``kernels.ops``) —
    phase A / lookup / resume / insert, with (``rc_compact``) the
    miss-compacted phase B.
    """

    window: int = 6            # sharing window N (frames per sort)
    margin: int = 4            # expanded-viewport margin, pixels per side
    capacity: int = 256        # per-tile Gaussian budget
    k_record: int = 5          # alpha-record length
    group_tiles: int = 4       # cache shared across group_tiles^2 tiles
    cache: rc.CacheConfig = rc.CacheConfig()
    sort_method: str = 'dense'
    max_tiles_per_gaussian: int = 16
    bg: float = 0.0
    use_s2: bool = True
    use_rc: bool = True
    backend: str = 'reference'  # 'reference' | 'kernel'
    shade_chunk: int = 64       # kernel backend: Gaussians per chunk iteration
    rc_compact: bool = True     # kernel backend: miss-compacted phase B

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f'unknown shade backend: {self.backend!r}')
        object.__setattr__(self, 'cache', self.cache._replace(k=self.k_record))


@dataclasses.dataclass(frozen=True)
class FrameStats:
    hit_rate: torch.Tensor           # fraction of pixels served from the cache
    sig_frac: torch.Tensor           # significant / iterated Gaussians
    mean_iterated: torch.Tensor      # average Gaussians iterated per pixel
    saved_frac: torch.Tensor         # fraction of integration skipped thanks to RC
    sorted_this_frame: torch.Tensor  # 1.0 if Projection+Sorting ran


def render_frame_baseline(scene: GaussianScene, cam: Camera, cfg: LuminaConfig,
                          *, live=None, early_exit: bool = True, device=None):
    """Full 3DGS pipeline (Projection -> Sorting -> Rasterization), no reuse.
    Returns (image [H,W,3], tile colors, RasterAux, TileLists).

    With ``early_exit`` (the default) it runs under ``torch.no_grad()``
    through the chunked early-exit rasterizer.  ``early_exit=False`` renders
    through the dense walk with autograd on for projection, gather and the
    walk, so a loss on the image reaches the scene's parameters (the
    fine-tuning loss); sorting stays integer and outside the graph.  The
    outputs are bit-identical either way.  ``live`` is the rasterizer's
    per-pixel liveness (``rasterize_tiles``)."""
    dev = resolve_device(device)
    check_on(dev, scene=scene.means, camera=cam.position)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not early_exit):
        proj = project(scene, cam)
        with torch.no_grad():
            lists = sort_scene(proj, cam.width, cam.height, cfg.capacity,
                               method=cfg.sort_method,
                               max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
        feats = gather_tile_features(proj, lists)
        colors, aux = rasterize_tiles(feats, lists.tiles_x,
                                      k_record=cfg.k_record, bg=cfg.bg,
                                      live=live, early_exit=early_exit)
        image = assemble_image(colors, lists.tiles_x, lists.tiles_y,
                               cam.width, cam.height)
    return image, colors, aux, lists


def rc_apply(cache: rc.CacheState, tile_colors: torch.Tensor, aux: RasterAux,
             tiles_x: int, tiles_y: int, cfg: LuminaConfig):
    """Radiance-cache lookup + update for one frame's tile colors.

    Returns (final tile colors, new cache, hit mask [T,P], saved-iteration
    fraction scalar)."""
    ids_g = regroup(aux.alpha_record, tiles_x, tiles_y, cfg.group_tiles)
    raw_g = regroup(tile_colors, tiles_x, tiles_y, cfg.group_tiles)
    hit, val, _, _, cache = rc.lookup_all_groups(cache, ids_g, cfg.cache)
    final_g = torch.where(hit[..., None], val, raw_g)
    cache = rc.insert_all_groups(cache, ids_g, raw_g, ~hit, cfg.cache)

    hit_t = ungroup(hit[..., None], tiles_x, tiles_y, cfg.group_tiles)[..., 0]
    final = ungroup(final_g, tiles_x, tiles_y, cfg.group_tiles)
    # A hit pixel stops after identifying its k significant Gaussians; pixels
    # whose record never filled (iter_at_k >= n_iterated) save nothing.
    saved = torch.where(hit_t, torch.clamp(aux.n_iterated - aux.iter_at_k,
                                           min=0), 0)
    saved_frac = saved.sum() / torch.clamp(aux.n_iterated.sum(), min=1)
    return final, cache, hit_t, saved_frac


def _stats(aux: RasterAux, hit, saved_frac, sorted_flag: float) -> FrameStats:
    tot_iter = torch.clamp(aux.n_iterated.sum(), min=1)
    return FrameStats(
        hit_rate=hit.float().mean(),
        sig_frac=aux.n_significant.sum() / tot_iter,
        mean_iterated=aux.n_iterated.float().mean(),
        saved_frac=torch.as_tensor(saved_frac, dtype=torch.float32),
        sorted_this_frame=torch.tensor(float(sorted_flag)),
    )


@dataclasses.dataclass(frozen=True)
class ViewerPrivate:
    """What one viewer carries that no one else can share.

    prev_cam  : camera of the previous rendered frame (pose prediction input)
    frame_idx : frame counter (drives the sort cadence)
    cell_id   : pose-cell key of the sort entry this viewer consumes (-1
                before the first sort)
    pool_idx  : index into its scene's ``SceneShared.pool``

    The slot-major form (``init_fleet``) holds S viewers: ``prev_cam`` is a
    stacked [S] camera and the three counters are [S] int64 numpy arrays,
    host values that the scheduler reads without a device sync.
    """

    prev_cam: Camera
    frame_idx: int
    cell_id: int
    pool_idx: int


@dataclasses.dataclass(frozen=True)
class SceneShared:
    """Per-scene state shared by every viewer of that scene.

    cache     : ONE radiance cache for the scene
    pool      : list of ``SortShared`` entries (None before their first sort)
    pool_cell : pose-cell key held by each entry (-1 = free)
    pool_refs : live viewers referencing each entry
    pool_tick : frame of each entry's last speculative sort (-window before
                any sort)

    The scene-major form (``init_fleet``) holds C scenes: ``cache`` leaves
    are [C, G, ...], ``pool`` is C tuples of entries (an entry not sorted
    yet is ``empty_sort_shared``), and ``pool_cell``/``pool_refs``/
    ``pool_tick`` are [C, P] int64 numpy arrays kept by the host scheduler.
    """

    cache: rc.CacheState
    pool: tuple
    pool_cell: tuple
    pool_refs: tuple
    pool_tick: tuple


@dataclasses.dataclass(frozen=True)
class ViewerState:
    """The single-viewer composition: one scene, one viewer, a pool of one."""

    scene_shared: SceneShared
    viewer: ViewerPrivate

    @property
    def cache(self) -> rc.CacheState:
        return self.scene_shared.cache

    @property
    def shared(self) -> SortShared | None:
        """The sort entry this viewer consumes."""
        return self.scene_shared.pool[self.viewer.pool_idx]

    @property
    def prev_cam(self) -> Camera:
        return self.viewer.prev_cam

    @property
    def frame_idx(self) -> int:
        return self.viewer.frame_idx


def init_scene_shared(scene: GaussianScene, cfg: LuminaConfig,
                      cam0: Camera) -> SceneShared:
    """Cold-start shared state for one scene at ``cam0``'s resolution, with
    a pool of one sort entry."""
    cache = rc.init_cache(num_groups(cam0.width, cam0.height, cfg.group_tiles),
                          cfg.cache, device=scene.device)
    return SceneShared(cache=cache, pool=(None,), pool_cell=(-1,),
                       pool_refs=(0,), pool_tick=(-cfg.window,))


def init_viewer_private(cam0: Camera) -> ViewerPrivate:
    """Cold-start private state for one viewer."""
    return ViewerPrivate(prev_cam=cam0, frame_idx=0, cell_id=-1, pool_idx=0)


def init_viewer_state(scene: GaussianScene, cfg: LuminaConfig,
                      cam0: Camera) -> ViewerState:
    """Cold-start state for one viewer rendering at ``cam0``'s resolution."""
    return ViewerState(scene_shared=init_scene_shared(scene, cfg, cam0),
                       viewer=init_viewer_private(cam0))


def sort_entry(scene: GaussianScene, private: ViewerPrivate, cam: Camera,
               cfg: LuminaConfig) -> SortShared:
    """Pose prediction + speculative Projection/Sorting for one viewer: the
    ``SortShared`` entry a sharing window consumes."""
    pred = predict_window_pose(private.prev_cam, cam, private.frame_idx,
                               cfg.window)
    return speculative_sort(scene, pred, margin=cfg.margin,
                            capacity=cfg.capacity, method=cfg.sort_method,
                            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)


def _put(seq: tuple, i: int, value) -> tuple:
    return seq[:i] + (value,) + seq[i + 1:]


def sort_phase(scene: GaussianScene, shared: SceneShared,
               private: ViewerPrivate, cam: Camera,
               cfg: LuminaConfig) -> SceneShared:
    """Phase 1 of a frame: run ``sort_entry`` and write it into the viewer's
    pool entry, stamping ``pool_tick`` with the viewer's frame counter.
    The cache is untouched."""
    entry = sort_entry(scene, private, cam, cfg)
    i = private.pool_idx
    return dataclasses.replace(shared, pool=_put(shared.pool, i, entry),
                               pool_tick=_put(shared.pool_tick, i,
                                              private.frame_idx))


def _prep_features(scene: GaussianScene, sort: SortShared | None, cam: Camera,
                   cfg: LuminaConfig):
    """Per-frame shade prep: the S^2 sorting-shared feature refresh of the
    given sort entry, or a fresh Projection+Sorting in baseline mode."""
    if cfg.use_s2:
        return shared_features(scene, cam, sort)
    proj = project(scene, cam)
    lists = sort_scene(proj, cam.width, cam.height, cfg.capacity,
                       method=cfg.sort_method,
                       max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
    return gather_tile_features(proj, lists), lists


def shade_phase(scene: GaussianScene, shared: SceneShared,
                private: ViewerPrivate, cam: Camera, cfg: LuminaConfig, *,
                sorted_flag: float = 0.0):
    """Phase 2 of a frame: sorting-shared prep + rasterization + radiance
    cache, consuming the viewer's pool entry.  Sort-free by construction.

    ``cfg.backend`` picks the shade: ``'reference'`` rasterizes everything
    and applies the cache after the fact (RC savings *modeled*);
    ``'kernel'`` runs prefix / lookup / miss-compacted resume / insert,
    where hits stop integration at the alpha-record (savings *measured* at
    chunk granularity).  The two agree on every integer cache decision;
    images agree to float32 ulps.

    Returns ``(new_shared, new_private, image, FrameStats)``.
    """
    tiles_x, tiles_y = tile_grid(cam.width, cam.height)
    feats, lists = _prep_features(scene, shared.pool[private.pool_idx], cam, cfg)

    if cfg.backend == 'kernel':
        from ..kernels import ops
        # significance-exact list trim: entries that cannot reach
        # alpha > 1/255 inside their tile at the render pose are dropped
        feats = ops.trim_features(feats, tiles_x)
        if cfg.use_rc:
            colors, cache, aux, kst = ops.rasterize_with_rc(
                feats, tiles_x, tiles_y, shared.cache, cfg.cache,
                cfg.group_tiles, k_record=cfg.k_record, chunk=cfg.shade_chunk,
                bg=cfg.bg, compact=cfg.rc_compact)
            hit = kst.hit
            saved_frac = 1.0 - ((kst.chunks_prefix + kst.chunks_resume).float()
                                / torch.clamp(kst.chunks_bound, min=1))
        else:
            colors, aux, _ = ops.rasterize_full(
                feats, tiles_x, k_record=cfg.k_record, chunk=cfg.shade_chunk,
                bg=cfg.bg)
            cache = shared.cache
            hit = torch.zeros(aux.n_iterated.shape, dtype=torch.bool,
                              device=colors.device)
            saved_frac = 0.0
    else:
        colors, aux = rasterize_tiles(feats, lists.tiles_x,
                                      k_record=cfg.k_record, bg=cfg.bg)
        if cfg.use_rc:
            colors, cache, hit, saved_frac = rc_apply(shared.cache, colors, aux,
                                                      tiles_x, tiles_y, cfg)
        else:
            cache = shared.cache
            hit = torch.zeros(aux.n_iterated.shape, dtype=torch.bool,
                              device=colors.device)
            saved_frac = 0.0

    image = assemble_image(colors, tiles_x, tiles_y, cam.width, cam.height)
    stats = _stats(aux, hit, saved_frac, sorted_flag)
    new_shared = dataclasses.replace(shared, cache=cache)
    new_private = dataclasses.replace(private, prev_cam=cam,
                                      frame_idx=private.frame_idx + 1)
    return new_shared, new_private, image, stats


def render_step(scene: GaussianScene, state: ViewerState, cam: Camera,
                cfg: LuminaConfig):
    """One frame of the Lumina pipeline: ``sort_phase`` when the frame
    counter hits the window cadence, then ``shade_phase``.  Returns
    ``(new_state, image, FrameStats)``."""
    shared, private = state.scene_shared, state.viewer
    with torch.no_grad():
        if cfg.use_s2:
            do_sort = private.frame_idx % cfg.window == 0
            if do_sort:
                shared = sort_phase(scene, shared, private, cam, cfg)
            sorted_flag = float(do_sort)
        else:
            sorted_flag = 1.0
        shared, private, image, stats = shade_phase(
            scene, shared, private, cam, cfg, sorted_flag=sorted_flag)
    return ViewerState(scene_shared=shared, viewer=private), image, stats


# ---------------------------------------------------------------------------
# The multi-viewer serving forms
# ---------------------------------------------------------------------------

def init_fleet(scene: GaussianScene, cfg: LuminaConfig, cam0: Camera,
               slots: int, viewers_per_scene: int = 1,
               pool_size: int | None = None):
    """Cold-start serving state: ``slots`` viewers over ``slots //
    viewers_per_scene`` scenes.  Returns ``(SceneShared`` in scene-major
    form, ``ViewerPrivate`` in slot-major form).  ``pool_size`` defaults to
    ``viewers_per_scene``, the worst case of every viewer in its own pose
    cell.  Every pool entry starts as one shared ``empty_sort_shared``."""
    v = viewers_per_scene
    if slots % v:
        raise ValueError(f'slots ({slots}) must be a multiple of '
                         f'viewers_per_scene ({v})')
    c = slots // v
    p = v if pool_size is None else pool_size
    empty = empty_sort_shared(scene, cam0, margin=cfg.margin,
                              capacity=cfg.capacity)
    shared = SceneShared(
        cache=rc.init_caches(c, num_groups(cam0.width, cam0.height,
                                           cfg.group_tiles),
                             cfg.cache, device=scene.device),
        pool=tuple((empty,) * p for _ in range(c)),
        pool_cell=np.full((c, p), -1, np.int64),
        pool_refs=np.zeros((c, p), np.int64),
        pool_tick=np.full((c, p), -cfg.window, np.int64))
    priv = ViewerPrivate(prev_cam=stack_cameras([cam0] * slots),
                         frame_idx=np.zeros((slots,), np.int64),
                         cell_id=np.full((slots,), -1, np.int64),
                         pool_idx=np.zeros((slots,), np.int64))
    return shared, priv


def viewer_at(priv: ViewerPrivate, i: int) -> ViewerPrivate:
    """Slot ``i`` of a slot-major ``ViewerPrivate`` in single-viewer form."""
    return ViewerPrivate(prev_cam=camera_at(priv.prev_cam, i),
                         frame_idx=int(priv.frame_idx[i]),
                         cell_id=int(priv.cell_id[i]),
                         pool_idx=int(priv.pool_idx[i]))


def privates_at(priv: ViewerPrivate, slots) -> ViewerPrivate:
    """The slot-major ``ViewerPrivate`` of the listed slots (a copy)."""
    return ViewerPrivate(prev_cam=camera_at(priv.prev_cam,
                                            torch.as_tensor(slots)),
                         frame_idx=priv.frame_idx[slots],
                         cell_id=priv.cell_id[slots],
                         pool_idx=priv.pool_idx[slots])


def scene_of_slot(slots: int, viewers_per_scene: int) -> np.ndarray:
    """Static slot -> scene map: slot ``i`` serves scene ``i // V``."""
    return np.arange(slots) // viewers_per_scene


def gather_sort_entries(shared: SceneShared, priv: ViewerPrivate,
                        viewers_per_scene: int = 1) -> list:
    """Each slot's ``SortShared``: ``pool[scene_of(slot)][pool_idx[slot]]``."""
    c_of = scene_of_slot(len(priv.pool_idx), viewers_per_scene)
    return [shared.pool[c][p] for c, p in zip(c_of, priv.pool_idx)]


def batched_sort_phase(scene: GaussianScene, privates: ViewerPrivate,
                       cams: Camera, cfg: LuminaConfig) -> list:
    """``sort_entry`` for each slot of a (small) slot-major cohort: the
    entries, in cohort order.  Where they land is the scheduler's call."""
    return [sort_entry(scene, viewer_at(privates, i), camera_at(cams, i), cfg)
            for i in range(len(privates.frame_idx))]


def batched_render_step(scene: GaussianScene, states: list, cams: Camera,
                        cfg: LuminaConfig):
    """``render_step`` of each slot (the parity oracle: every lane keeps its
    own sort cadence).  ``states`` is a list of ``ViewerState``, ``cams`` a
    stacked camera.  Returns (states, images [S, H, W, 3], per-slot
    ``FrameStats`` with [S] leaves)."""
    outs = [render_step(scene, st, camera_at(cams, i), cfg)
            for i, st in enumerate(states)]
    stats = FrameStats(*(torch.stack([torch.as_tensor(getattr(o[2], f))
                                      for o in outs])
                         for f in ('hit_rate', 'sig_frac', 'mean_iterated',
                                   'saved_frac', 'sorted_this_frame')))
    return [o[0] for o in outs], torch.stack([o[1] for o in outs]), stats


def stats_at(stats: FrameStats, i: int) -> FrameStats:
    """Slot ``i`` of per-slot ``FrameStats``."""
    return FrameStats(*(x[i] for x in (stats.hit_rate, stats.sig_frac,
                                       stats.mean_iterated, stats.saved_frac,
                                       stats.sorted_this_frame)))


def _stats_slots(aux: RasterAux, hit, saved_frac, sorted_flags) -> FrameStats:
    """``_stats`` of each slot: [S] leaves."""
    tot_iter = torch.clamp(aux.n_iterated.sum(dim=(1, 2)), min=1)
    return FrameStats(
        hit_rate=hit.float().mean(dim=(1, 2)),
        sig_frac=aux.n_significant.sum(dim=(1, 2)) / tot_iter,
        mean_iterated=aux.n_iterated.float().mean(dim=(1, 2)),
        saved_frac=saved_frac.float(),
        sorted_this_frame=sorted_flags.float())


def _stack_features(feats: list) -> TileFeatures:
    return TileFeatures(*(torch.stack([getattr(f, name) for f in feats])
                          for name in ('mean2d', 'conic', 'color', 'opacity',
                                       'ids')))


def batched_prep_features(scene: GaussianScene, shared: SceneShared,
                          priv: ViewerPrivate, cams: Camera,
                          cfg: LuminaConfig,
                          viewers_per_scene: int = 1) -> TileFeatures:
    """Per-slot shade prep (``_prep_features``, one call per slot):
    [S, T, K, ...] feature stacks."""
    sorts = gather_sort_entries(shared, priv, viewers_per_scene)
    return _stack_features([_prep_features(scene, so, camera_at(cams, i),
                                           cfg)[0]
                            for i, so in enumerate(sorts)])


def trim_features_slots(feats_b: TileFeatures, tiles_x: int) -> TileFeatures:
    """``ops.trim_features`` over [S, T, K, ...] feature stacks (the same
    per-row math as the per-slot trim)."""
    from ..kernels import ops
    s, t = feats_b.ids.shape[:2]
    flat = ops.trim_features(TileFeatures(*(
        x.reshape(s * t, *x.shape[2:]) for x in (
            feats_b.mean2d, feats_b.conic, feats_b.color, feats_b.opacity,
            feats_b.ids))), tiles_x, t_img=t)
    return TileFeatures(*(x.reshape(s, t, *x.shape[1:]) for x in (
        flat.mean2d, flat.conic, flat.color, flat.opacity, flat.ids)))


def batched_shade_phase(scene: GaussianScene, shared: SceneShared,
                        priv: ViewerPrivate, cams: Camera,
                        sorted_flags: torch.Tensor, active: torch.Tensor,
                        cfg: LuminaConfig, viewers_per_scene: int = 1):
    """The per-tick shade of all serving slots over scene-shared state.

    ``shared`` is scene-major (C = S // viewers_per_scene scenes), ``priv``
    and ``cams`` slot-major; ``sorted_flags`` [S] float32 and ``active`` [S]
    bool are per-slot values from the scheduler, on the scene's device.
    Returns ``(new_shared, new_priv, images [S, H, W, 3], FrameStats with
    [S] leaves)``.

    The cache stages run scene-major over the flattened C * G groups: every
    viewer of a scene probes and fills its one cache, conflicts resolving in
    (slot, pixel) order, and idle lanes (``active`` False) neither touch the
    LRU state nor insert.  With ``viewers_per_scene == 1`` every slot owns
    a private cache and each lane equals ``shade_phase``.  The kernel
    backend runs the slot-batched kernels (``ops.rasterize_with_rc_slots``),
    whose chunk counts are fleet totals: ``saved_frac`` there is the
    fleet's measured saving, the same value for every slot.
    """
    if cfg.backend == 'kernel':
        return _batched_shade_kernel(scene, shared, priv, cams, sorted_flags,
                                     active, cfg, viewers_per_scene)
    s = sorted_flags.shape[0]
    v = viewers_per_scene
    c = s // v
    tiles_x, tiles_y = tile_grid(cams.width, cams.height)
    sorts = gather_sort_entries(shared, priv, v)
    outs = []
    for i, sort in enumerate(sorts):
        feats, lists = _prep_features(scene, sort, camera_at(cams, i), cfg)
        outs.append(rasterize_tiles(feats, lists.tiles_x,
                                    k_record=cfg.k_record, bg=cfg.bg,
                                    live=active[i]))
    colors = torch.stack([o[0] for o in outs])
    aux = RasterAux(*(torch.stack([getattr(o[1], f) for o in outs])
                      for f in ('alpha_record', 'n_significant', 'n_iterated',
                                'iter_at_k', 'transmittance')))

    if cfg.use_rc:
        gt = cfg.group_tiles
        ids_v = rc.viewer_major(
            regroup_slots(aux.alpha_record, tiles_x, tiles_y, gt), v)
        raw_v = rc.viewer_major(regroup_slots(colors, tiles_x, tiles_y, gt), v)
        live_v = rc.viewer_major(active[:, None].expand(s, ids_v.shape[1] // c),
                                 v)
        hit_v, val_v, _, _, cache_f = rc.lookup_all_groups_multi(
            rc.flatten_scenes(shared.cache), ids_v, cfg.cache, live=live_v)
        final_v = torch.where(hit_v[..., None], val_v, raw_v)
        cache_f = rc.insert_all_groups_multi(
            cache_f, ids_v, raw_v,
            ~hit_v & rc.viewer_live(live_v, hit_v.shape), cfg.cache)
        caches = rc.split_scenes(cache_f, c)
        hit = ungroup_slots(rc.slot_order(hit_v, c)[..., None], tiles_x,
                            tiles_y, gt)[..., 0]
        colors = ungroup_slots(rc.slot_order(final_v, c), tiles_x, tiles_y,
                               gt)
        # the modeled per-pixel saving of rc_apply, per slot
        saved = torch.where(hit, torch.clamp(aux.n_iterated - aux.iter_at_k,
                                             min=0), 0)
        saved_frac = (saved.sum(dim=(1, 2))
                      / torch.clamp(aux.n_iterated.sum(dim=(1, 2)), min=1))
    else:
        caches = shared.cache
        hit = torch.zeros(aux.n_iterated.shape, dtype=torch.bool,
                          device=colors.device)
        saved_frac = torch.zeros((s,), device=colors.device)
    return _finish_slots(shared, priv, cams, caches, colors, aux, hit,
                         saved_frac, sorted_flags, tiles_x, tiles_y)


def _finish_slots(shared, priv, cams, caches, colors, aux, hit, saved_frac,
                  sorted_flags, tiles_x, tiles_y):
    images = torch.stack([assemble_image(cl, tiles_x, tiles_y, cams.width,
                                         cams.height) for cl in colors])
    stats = _stats_slots(aux, hit, saved_frac, sorted_flags)
    new_shared = dataclasses.replace(shared, cache=caches)
    new_priv = dataclasses.replace(priv, prev_cam=cams,
                                   frame_idx=priv.frame_idx + 1)
    return new_shared, new_priv, images, stats


def _batched_shade_kernel(scene: GaussianScene, shared: SceneShared,
                          priv: ViewerPrivate, cams: Camera,
                          sorted_flags: torch.Tensor, active: torch.Tensor,
                          cfg: LuminaConfig, viewers_per_scene: int = 1):
    """Slot-batched kernel shade over scene-shared caches (see
    ``batched_shade_phase``)."""
    from ..kernels import ops
    tiles_x, tiles_y = tile_grid(cams.width, cams.height)
    s = sorted_flags.shape[0]
    feats_b = batched_prep_features(scene, shared, priv, cams, cfg,
                                    viewers_per_scene)
    feats_b = trim_features_slots(feats_b, tiles_x)
    if cfg.use_rc:
        colors, caches, aux, kst = ops.rasterize_with_rc_slots(
            feats_b, tiles_x, tiles_y, shared.cache, cfg.cache,
            cfg.group_tiles, viewers_per_scene=viewers_per_scene,
            k_record=cfg.k_record, chunk=cfg.shade_chunk, bg=cfg.bg,
            live=active, compact=cfg.rc_compact)
        hit = kst.hit
        # fleet-coupled chunk accounting -> the fleet's measured saving
        saved = 1.0 - ((kst.chunks_prefix + kst.chunks_resume).float()
                       / torch.clamp(kst.chunks_bound, min=1))
        saved_b = saved.expand(s)
    else:
        colors, aux, _ = ops.rasterize_full_slots(
            feats_b, tiles_x, k_record=cfg.k_record, chunk=cfg.shade_chunk,
            bg=cfg.bg, live=active)
        caches = shared.cache
        hit = torch.zeros(aux.n_iterated.shape, dtype=torch.bool,
                          device=colors.device)
        saved_b = torch.zeros((s,), device=colors.device)
    return _finish_slots(shared, priv, cams, caches, colors, aux, hit,
                         saved_b, sorted_flags, tiles_x, tiles_y)


class LuminSys:
    """Stateful frame sequencer: carries one ``ViewerState`` through
    ``render_step``.

    Usage::

        sys = LuminSys(scene, cfg, cam0)            # on the card
        for cam in trajectory:
            image, stats = sys.step(cam)

    ``device`` defaults to the card and raises when none is present; the
    scene and cameras must lie on it.
    """

    def __init__(self, scene: GaussianScene, cfg: LuminaConfig, cam0: Camera,
                 *, device=None):
        self.device = resolve_device(device)
        check_on(self.device, scene=scene.means, camera=cam0.position)
        self.scene = scene
        self.cfg = cfg
        self.state = init_viewer_state(scene, cfg, cam0)

    @property
    def cache(self) -> rc.CacheState:
        return self.state.cache

    @property
    def frame_idx(self) -> int:
        return self.state.frame_idx

    def step(self, cam: Camera):
        check_on(self.device, camera=cam.position)
        self.state, image, stats = render_step(self.scene, self.state, cam,
                                               self.cfg)
        return image, stats
