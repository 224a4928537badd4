"""Device meshes over ``torch.distributed``, and device placement for the
serving fleet.

The mesh builders are functions, never module-level constants, so
importing this module touches no process group.  Each builds a
``DeviceMesh`` with ``init_device_mesh`` on the process group that the
caller initialised (``torch.distributed.init_process_group``: NCCL on the
cards, gloo on the CPU), one rank per device, and raises ``RuntimeError``
when the world is smaller than the mesh.  ``device`` is resolved as every
entry point resolves it: the card unless the caller asks for the CPU.

Production target of the JAX package: a pod of 16 x 16 = 256 devices
``(data, model)``; multi-pod adds a leading ``pod`` axis (2 x 16 x 16).
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..runtime.sharding import DEVICES_AXIS


def _mesh(shape: tuple, axes: tuple, device, hint: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f'need {n} ranks for the {hint} mesh {dict(zip(axes, shape))}, '
            f'have {have}: initialise a process group of {n} ranks first '
            f'(torchrun --nproc-per-node {n}, or gloo on the CPU)')
    if have > n:
        raise RuntimeError(f'the {hint} mesh takes all {have} ranks of the '
                           f'world, not {n}: use elastic.build_mesh for a '
                           'mesh over fewer')
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ('pod', 'data', 'model')
    return (16, 16), ('data', 'model')


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return _mesh(*production_shape(multi_pod), device, 'production')


def make_test_mesh(shape=(2, 2), axes=('data', 'model'), device=None):
    """Small mesh for tests (4 ranks by default)."""
    return _mesh(tuple(shape), tuple(axes), device, 'test')


def make_serve_mesh(num_devices: int | None = None, device=None):
    """1-D ``devices`` mesh for the sharded serving fleet, one rank per
    scene-block worker (all ranks of the world by default)."""
    import torch.distributed as dist
    n = num_devices
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n,), (DEVICES_AXIS,), device, 'serving')


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
