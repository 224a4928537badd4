"""Elastic re-meshing: shrink or grow the device mesh across failures, as
the JAX package's ``runtime.elastic``.

Recovery contract (with ``repro_torch.checkpoint``: state is saved as
host tensors, so re-sharding is placing them on the new mesh):

  1. a node failure (or straggler exclusion) is detected;
  2. the launcher picks the largest valid mesh that fits the survivors —
     valid: the 'model' extent is kept (the TP degree is baked into padded
     head counts and expert placement), the batch axes shrink;
  3. state is restored from the latest checkpoint onto the new mesh;
  4. gradient accumulation steps grow to keep the global batch.

The planning is pure integer logic, so every surviving host computes the
same plan from the shared failure list.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from .sharding import distribute_tree


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    axes: tuple                 # mesh axis names
    shape: tuple                # new mesh shape
    devices_used: int
    grad_accum_factor: int      # multiply accumulation steps by this
    dropped_devices: int


def plan_remesh(total_devices: int, failed_devices: int, *,
                model: int = 16, axes: Sequence[str] = ('data', 'model'),
                old_data: Optional[int] = None) -> RemeshPlan:
    """Largest (data', model) mesh fitting the survivors; keep global batch.

    'model' is kept; 'data' shrinks to the largest extent that divides the
    old one, so the global batch still shards evenly and gradient
    accumulation stays integral.
    """
    survivors = total_devices - failed_devices
    if survivors < model:
        raise ValueError(f'cannot keep model={model} with {survivors} devices')
    new_data = survivors // model
    old_data = old_data or total_devices // model
    while new_data > 1 and old_data % new_data != 0:
        new_data -= 1
    used = new_data * model
    return RemeshPlan(
        axes=tuple(axes), shape=(new_data, model),
        devices_used=used,
        grad_accum_factor=old_data // new_data,
        dropped_devices=total_devices - used,
    )


def build_mesh(plan: RemeshPlan, device=None):
    """A ``DeviceMesh`` of the plan's shape over ranks 0 .. devices_used-1
    of the initialised process group (every rank of the world calls it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = plan.devices_used
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f'need {n} ranks, have {have}')
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(plan.shape),
                      mesh_dim_names=tuple(plan.axes))


def reshard_tree(tree, spec_tree, mesh):
    """Place a host tree (tensors or numpy arrays in dicts, lists and
    tuples) onto ``mesh`` as DTensors, each with the spec at the same place
    of ``spec_tree`` (``sharding.distribute_tree``).  Used after restore:
    every survivor restored the same checkpoint, so this is the only
    placement step of elastic recovery, and ``full_tensor()`` gives each
    value back."""
    return distribute_tree(tree, spec_tree, mesh)


class ElasticRunner:
    """Bookkeeping the launcher drives: ``step_failure(failed)`` returns the
    new plan; the launcher then builds the new mesh and restores from the
    checkpoint manager."""

    def __init__(self, total_devices: int, model_extent: int):
        self.total = total_devices
        self.model = model_extent
        self.failed: set[int] = set()

    def step_failure(self, failed_ids: Sequence[int]) -> RemeshPlan:
        self.failed.update(failed_ids)
        return plan_remesh(self.total, len(self.failed), model=self.model)

    def step_recovery(self, recovered_ids: Sequence[int]) -> RemeshPlan:
        self.failed.difference_update(recovered_ids)
        return plan_remesh(self.total, len(self.failed), model=self.model)
