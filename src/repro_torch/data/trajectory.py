"""Camera trajectories modelling the paper's evaluation settings: a VR
scenario with ~25 deg/s average head rotation at 90 FPS (paper Sec. 5)."""
from __future__ import annotations

import math

from ..core.camera import Camera, look_at, make_camera
from ..device import resolve_device


def orbit_trajectory(num_frames: int, *, fps: float = 90.0,
                     deg_per_sec: float = 25.0, radius: float = 2.2,
                     height: float = 0.25, width: int = 128,
                     height_px: int = 128, fov_x_deg: float = 60.0,
                     start_deg: float = 0.0, translate_per_sec: float = 0.05,
                     device=None) -> list[Camera]:
    """Orbit around the origin with VR-like angular velocity + slow drift.
    The poses are computed on the host; the cameras lie on ``device`` (the
    card by default)."""
    dev = resolve_device(device)
    cams = []
    for i in range(num_frames):
        t = i / fps
        ang = math.radians(start_deg + deg_per_sec * t)
        pos = (radius * math.sin(ang), height + translate_per_sec * t,
               radius * math.cos(ang))
        p, q = look_at(pos, (0.0, 0.0, 0.0))
        cams.append(make_camera(p, q, fov_x_deg, width, height_px, device=dev))
    return cams
