"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a quiet fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (by
    default or by name) and ``torch.cuda.is_available()`` is False."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'repro_torch runs on the GPU by default, but torch finds no CUDA '
            "device; pass device='cpu' to run the plain PyTorch versions")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f'{name} lies on {t.device}, expected {device}')
