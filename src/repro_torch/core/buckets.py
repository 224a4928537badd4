"""Power-of-two capacity buckets.

Dynamic batch widths (active scene blocks, live lanes inside a scene
block, live sort-pool entries per scene) are rounded up to the next
power of two before they reach a jitted call. That bounds the number
of distinct compiled shapes to ``log2(max_width)`` instead of
``max_width`` — the same capacity-bucket trick dropless-MoE routers
use for token→expert dispatch.

One helper, used by the stepper's scene-block compaction, the
within-scene lane compaction, and the bucketed sort-pool capacity.
"""

from __future__ import annotations


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= ``n``, optionally clamped to ``cap``.

    ``n <= 0`` maps to the minimum bucket of 1 (a jitted call always
    has at least one lane).  When ``cap`` is given the result is
    ``min(bucket, cap)`` — callers clamp to the physical width, and
    ``cap`` itself need not be a power of two (a full-width dispatch
    at an odd width is still a single compiled shape).
    """
    if cap is not None and cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    b = 1
    while b < n:
        b *= 2
    if cap is not None and b > cap:
        b = cap
    return b
