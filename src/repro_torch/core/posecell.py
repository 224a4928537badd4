"""Pose cells — quantized camera poses for scene-level sort sharing.

The S^2 speculative sort is built with an expanded viewport whose ``margin``
(pixels per side, rounded up to whole tiles) absorbs the pose drift of one
sharing window.  The same margin headroom lets *different viewers* of one
scene consume one sort, provided their poses are close enough that the
projection error between them stays inside it.  A **pose cell** is the
bucket of poses the scheduler treats as "close enough": position quantized
on a world-space grid of pitch ``cell_size`` and view direction quantized
into ``ang_bins`` azimuth/elevation (and roll) buckets.

Margin safety is a small-angle budget, not a proof: two cameras in one cell
differ by at most the cell diagonal ``sqrt(3) * cell_size`` in position and
one angular bin in orientation.  A position error ``d`` at scene depth ``z``
shifts projections by ~``f * d / z`` pixels and an orientation error
``theta`` by ~``f * theta``; with the repo defaults (f ~= 55 px at 64 px /
60 deg fov, z >~ 1, margin = 4 px rounded up to a 16 px tile) the defaults
below keep the combined shift a fraction of the *tile-rounded* margin the
expanded grid actually allocates.  Scenes with extreme close-ups should
shrink ``cell_size`` (the scheduler degrades gracefully: smaller cells just
mean less sharing, never wrong tiles beyond what the single-viewer window
drift already permits).

Keys are computed host-side (the sort scheduler is host-driven and a camera
is seven floats); they are plain non-negative ``int32`` values so they can
ride in the ``SceneShared.pool_cell`` bookkeeping.  A camera made on the
host carries a host copy of its pose (``Camera.host_pose``), which is what
the key reads: planning a tick never copies a pose back from the card.  A
camera without one (made from device tensors) is read back, which syncs.
"""
from __future__ import annotations

import numpy as np

CELL_SIZE = 0.05     # world-units position quantum (see margin budget above)
ANG_BINS = 256       # direction buckets per axis (360/256 ~= 1.4 deg)


def host_pose(cam) -> tuple[np.ndarray, np.ndarray]:
    """``(position, quat)`` of a camera as float32 numpy arrays: its host
    copy when it has one, else the tensors read back (a device sync)."""
    if getattr(cam, 'host_pose', None) is not None:
        return cam.host_pose
    return (cam.position.detach().cpu().numpy(),
            cam.quat.detach().cpu().numpy())


def _fwd_up(quat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Camera forward (+z) and up (-y, since image y grows down) axes in
    world coordinates, from a (w,x,y,z) world-from-camera quaternion."""
    w, x, y, z = quat / (np.linalg.norm(quat) + 1e-12)
    fwd = np.array([2 * (x * z + w * y),
                    2 * (y * z - w * x),
                    1 - 2 * (x * x + y * y)])
    down = np.array([2 * (x * y - w * z),
                     1 - 2 * (x * x + z * z),
                     2 * (y * z + w * x)])
    return fwd, -down


def angle_bucket(x: float, lo: float, span: float, ang_bins: int,
                 periodic: bool = True) -> int:
    """Quantize an angle into one of ``ang_bins`` buckets over [lo, lo+span).

    Bins are **zero-centered**: a bin CENTER sits at every ``lo + k * span /
    ang_bins`` (half-bin offset before the floor), so the ubiquitous
    upright-camera roll ~= 0 (and axis-aligned headings) cannot flip buckets
    on float noise around a floor boundary.  Periodic axes wrap modulo
    ``ang_bins``; non-periodic axes clamp — elevation must NOT wrap, or
    straight-up (el = +pi/2) would fuse with straight-down (el = -pi/2).
    """
    b = int(np.floor((x - lo) / span * ang_bins + 0.5))
    if periodic:
        return b % ang_bins
    return min(ang_bins - 1, max(0, b))


def pose_cell_buckets(cam, *, cell_size: float = CELL_SIZE,
                      ang_bins: int = ANG_BINS) -> tuple:
    """The raw quantization a pose-cell key hashes: ``(ix, iy, iz, az, el,
    roll)`` — three integer position-grid coordinates (floor at pitch
    ``cell_size``) and three ``angle_bucket`` indices.

    Two cameras share a pose cell iff these six coordinates all coincide;
    neighboring position cells differ in exactly one coordinate by exactly
    one.  Exposed separately from ``pose_cell_key`` so tests (and any future
    adaptive-cell logic) can reason about the geometry instead of a hash.
    """
    position, quat = host_pose(cam)
    p = np.asarray(position, np.float64).reshape(3)
    q = np.asarray(quat, np.float64).reshape(4)
    fwd, up = _fwd_up(q)

    az = np.arctan2(fwd[0], fwd[2])
    el = np.arcsin(np.clip(fwd[1], -1.0, 1.0))
    # roll: angle of the up vector around the forward axis, measured against
    # a forward-orthogonal reference frame
    ref = np.array([0.0, 1.0, 0.0])
    if abs(fwd[1]) > 0.9:                       # forward ~ vertical
        ref = np.array([1.0, 0.0, 0.0])
    e1 = np.cross(ref, fwd)
    e1 /= np.linalg.norm(e1) + 1e-12
    e2 = np.cross(fwd, e1)
    roll = np.arctan2(float(up @ e1), float(up @ e2))

    two_pi = 2.0 * np.pi
    return (
        int(np.floor(p[0] / cell_size)),
        int(np.floor(p[1] / cell_size)),
        int(np.floor(p[2] / cell_size)),
        angle_bucket(az, -np.pi, two_pi, ang_bins),
        angle_bucket(el, -np.pi / 2, np.pi, ang_bins, periodic=False),
        angle_bucket(roll, -np.pi, two_pi, ang_bins),
    )


def pose_cell_key(cam, *, cell_size: float = CELL_SIZE,
                  ang_bins: int = ANG_BINS) -> int:
    """Quantize a camera pose into a deterministic pose-cell key.

    Two cameras get the same key iff their quantized position cells and
    direction buckets (forward azimuth/elevation plus an up-vector roll
    bucket) all coincide — see ``pose_cell_buckets``.  Returns a
    non-negative python int < 2**31.
    """
    buckets = pose_cell_buckets(cam, cell_size=cell_size, ang_bins=ang_bins)
    # FNV-1a over the bucket tuple -> stable 31-bit key (non-negative, so -1
    # stays free as the "empty pool entry" sentinel)
    h = 2166136261
    for b in buckets:
        h = ((h ^ (b & 0xFFFFFFFF)) * 16777619) & 0xFFFFFFFF
    return int(h & 0x7FFFFFFF)
