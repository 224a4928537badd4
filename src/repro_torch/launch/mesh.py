"""Device placement for the serving fleet.

The JAX package's mesh builders (``make_production_mesh``,
``make_test_mesh``, ``make_serve_mesh``) build XLA meshes for the LM
substrate and have no caller in the port yet; only ``serve_devices``, the
fleet's per-worker placement, is here.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def serve_devices(num_workers: int, device=None) -> list[torch.device]:
    """One ``torch.device`` per fleet worker, cycling over the cards.

    ``device`` is resolved as every entry point resolves it (the card by
    default, raising when there is none).  On CUDA the workers cycle over
    ``torch.cuda.device_count()`` cards (``cuda:i % n``), so a machine with
    fewer cards than workers oversubscribes them, as single-card CI does;
    on the CPU every worker gets ``cpu``.  Workers are independent host
    loops over their own steppers, not collective participants, so a card
    may carry several."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        return [dev] * num_workers
    n = torch.cuda.device_count()
    return [torch.device('cuda', i % n) for i in range(num_workers)]
