"""Head and vocab padding for tensor parallelism, and the context that the
LM entry points carry.

The JAX package's recipes map tensor dimensions onto a device mesh and
constrain activations to those layouts; with no mesh every constraint is
the identity.  The port has no mesh yet, so its model code calls no layout
hook.  What a mesh's model-axis size ``tp`` still decides here is the
padding of q heads and of the vocab, so parameter shapes equal the JAX
package's for every ``tp``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The distribution recipe and the model-axis size used for padding."""

    recipe: str = 'tp'
    tp: int = 1


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def padded_heads(n_heads: int, tp: int) -> int:
    """Pad a head count to TP divisibility (extra heads are masked)."""
    return pad_to_multiple(n_heads, max(tp, 1))


def replicated_kv_heads(n_kv: int, tp: int) -> int:
    """GQA kv heads replicated so the model axis divides them evenly."""
    if tp <= 1 or n_kv % tp == 0:
        return n_kv
    if tp % n_kv == 0:
        return tp                     # replicate each kv head tp/n_kv times
    return pad_to_multiple(n_kv, tp)  # fall back to padding
