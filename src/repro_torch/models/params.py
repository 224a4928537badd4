"""A JAX parameter tree as an ``nn.Module``.

The JAX package keeps a model's weights as nested dicts of arrays, with
each run of layers stacked on a leading axis for ``lax.scan``.  The port
keeps the same tree with each stacked axis unstacked into a list, one
entry a layer: ``ParamTree`` registers every tensor as a parameter and
every dict or list as a child module under the tree's own key, so
``named_parameters`` reads as the JAX tree's path with a layer index for
each unstacked axis (``blocks.3.mlstm.2.wq`` is JAX's
``blocks/mlstm/wq[3, 2]``).  Layer functions index it as they index the
dict: ``p['wq']``, ``'unembed' in p``, ``p.get('w_gate')``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..runtime.sharding import ShardCtx, as_dtensor_like
from . import layers as L


class ParamTree(nn.Module):
    """Nested dicts and lists of tensors as parameters and child modules."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def items(self):
        """The (name, tensor) pairs of the tensors at this node (a
        layer's weights, as ``ShardCtx.weights`` reads a mapping)."""
        return self._parameters.items()


class LM(ParamTree):
    """A family's model: its parameter tree and its config, with the
    shared embedding ends (``tok``)."""

    def __init__(self, cfg, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def logits(self, x: torch.Tensor,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        return L.logits(self.tok, x, self.cfg, ctx)


def positions(ref: torch.Tensor) -> torch.Tensor:
    """Positions 0..S-1 of each row of a batch ``ref`` [B, S, ...], [B, S]
    int32, laid out as ``ref`` when it is a DTensor (each rank makes its
    own block)."""
    b, s = ref.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=ref.device)[None]
    return as_dtensor_like(pos.expand(b, s), ref,
                           getattr(ref, 'placements', None))
