"""Hand-written Hopper kernels (``csrc/*.cu``) beside their plain PyTorch
versions.  A wrapper takes its plain version only when its tensors lie on
the CPU; on CUDA tensors it launches the kernel or raises.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else.
"""

LAUNCHES = {'rasterize': 0, 'rasterize_slots': 0, 'rasterize_compact': 0,
            'rc_lookup': 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
