"""Sharding recipes over a ``torch.distributed`` device mesh, and the head
and vocab padding for tensor parallelism, as the JAX package's
``runtime.sharding``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (``launch.mesh`` builds one), or a shape-only stand-in
with a ``.shape`` dict and ``.axis_names``, which is all the spec rules
read.  The production meshes are ``(data=16, model=16)`` and ``(pod=2,
data=16, model=16)``; the recipes map tensor dimensions onto those axes:

  * ``tp``  : TP over ``model`` (heads / d_ff / vocab), FSDP over ``data``,
              batch over pod x data, the residual sequence over ``model``;
  * ``dp``  : parameters replicated, batch over pod x data;
  * ``ep``  : MoE experts over ``model``, their rows over ``data``;
  * ``ssm`` : as ``tp``, and a long context's KV sequence over ``data``.

Every rule is divisibility-adaptive (``adaptive_spec``): an axis lands on a
tensor dimension only when the axes' size divides it, so the same rules
serve every shape.  A spec is the port's own ``P``, a tuple of entries
(``None``, an axis name, or a tuple of names) equal to the JAX package's
``PartitionSpec`` entries.

The port runs one process per rank, every rank the same program on
replicated values; the bodies that change what is computed (the
expert-parallel MoE, the compressed all-reduce, GPipe, the sharded frame)
slice their rank's block and run real collectives (``runtime.spmd``).  The
layout hooks of ``ShardCtx`` are the counterpart of the JAX package's
``with_sharding_constraint``: a plain tensor passes unchanged, a
``DTensor`` is redistributed to the hook's layout.  The model code does not
call them yet (DTensor TP and FSDP are later work).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

Axes = Union[str, tuple]

#: 1-D serving-fleet mesh axis: scene blocks shard across devices, one host
#: worker per device (``serve.fleet``, ``launch.mesh.make_serve_mesh``).
DEVICES_AXIS = 'devices'


class P(tuple):
    """A partition spec: one entry per leading tensor dimension, each
    ``None`` (replicated), an axis name, or a tuple of axis names (the
    first the major one).  A one-name tuple is stored as the name, as the
    JAX package's ``PartitionSpec`` stores it, so the entries equal its:
    ``P(('data',), None) == ('data', None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f'P{tuple(self)!r}'


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh`` in the mesh's order ({} for
    None): a ``DeviceMesh`` with ``mesh_dim_names``, or a stand-in with a
    ``.shape`` dict and ``.axis_names``."""
    if mesh is None:
        return {}
    names = getattr(mesh, 'mesh_dim_names', None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape, names = getattr(mesh, 'shape', None), getattr(mesh, 'axis_names',
                                                         None)
    if isinstance(shape, dict) and names is not None:
        return {n: shape[n] for n in names}
    raise NotImplementedError(
        f'cannot read a device mesh from {type(mesh).__name__}: the port '
        "takes a DeviceMesh with mesh_dim_names, or a stand-in with a "
        '.shape dict and .axis_names')


def fleet_axis_sharding(mesh) -> Optional[list]:
    """Placements of a leading-axis sharding over the serving fleet's
    ``devices`` axis (None mesh -> None, the single-device no-op)."""
    if mesh is None:
        return None
    return spec_to_placements(P(DEVICES_AXIS), mesh)


def batch_axes(mesh) -> tuple:
    return tuple(n for n in mesh_axes(mesh) if n in ('pod', 'data'))


def all_axes(mesh) -> tuple:
    return tuple(mesh_axes(mesh))


def axes_size(mesh, axes: Axes) -> int:
    if mesh is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def adaptive_spec(shape: Sequence[int], mesh,
                  assignments: Sequence[tuple]) -> P:
    """Build a spec from (dim, axes) preferences.

    Each assignment is tried in order; it lands only if the dimension is
    still free, the axes are still free, and the dimension size is divisible
    by the axes' total size.  Negative dims count from the end.
    """
    spec: list = [None] * len(shape)
    used: set = set()
    for dim, axes in assignments:
        if axes is None:
            continue
        was_str = isinstance(axes, str)
        if was_str:
            axes = (axes,)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            continue
        d = dim if dim >= 0 else len(shape) + dim
        if d < 0 or d >= len(shape) or spec[d] is not None:
            continue
        size = axes_size(mesh, axes)
        if size <= 1 or shape[d] % size != 0:
            continue
        # a bare string stays a bare axis; ``P`` stores a one-name tuple as
        # the name, as the JAX package's PartitionSpec does
        spec[d] = axes[0] if was_str and len(axes) == 1 else axes
        used.update(axes)
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_to_placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dimension that an entry of tensor dim ``d`` names, else
    ``Replicate()``.  DTensor nests the mesh dimensions that shard one
    tensor dimension in the mesh's order, so a tuple entry must list its
    axes in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = all_axes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f'spec entry {entry!r} is not in the order of '
                             f'the mesh axes {names}')
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh, the distribution recipe, the model-axis size used for head
    padding, and the long-context KV layout, with the logical activation
    layouts as hooks."""

    mesh: object = None
    recipe: str = 'tp'
    tp: int = 1                 # model-axis size used for head padding
    seq_shard_kv: bool = False  # long-context: shard KV sequence over 'data'

    def _constrain(self, x, assignments):
        from torch.distributed.tensor import DTensor
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        spec = adaptive_spec(x.shape, self.mesh, assignments)
        return x.redistribute(self.mesh, spec_to_placements(spec, self.mesh))

    def _baxes(self) -> tuple:
        # 'fsdp' (ZeRO-3): the model axis carries batch, not tensor shards
        if self.recipe == 'fsdp':
            return all_axes(self.mesh)
        return batch_axes(self.mesh)

    # ---- logical activation layouts ----
    def btd(self, x):
        """[batch, seq, d_model] — batch over pod x data, seq over model."""
        return self._constrain(x, [(0, self._baxes()), (1, 'model')])

    def bthd(self, x):
        """[batch, seq, heads, head_dim] — heads over model, never head_dim
        (a sharded contraction dim makes every score block a partial sum)."""
        return self._constrain(x, [(0, self._baxes()), (2, 'model')])

    def btf(self, x):
        """[batch, seq, d_ff] — d_ff over model (TP)."""
        return self._constrain(x, [(0, self._baxes()), (2, 'model')])

    def btv(self, x):
        """[batch, seq, vocab] (logits) — vocab over model."""
        return self._constrain(x, [(0, self._baxes()), (2, 'model')])

    def kv_cache(self, x):
        """[batch, seq, kv_heads, head_dim] — sequence over 'model'; long
        context (batch 1): sequence over 'data', heads (else head_dim) over
        'model'."""
        if self.seq_shard_kv:
            return self._constrain(x, [(1, 'data'), (2, 'model'),
                                       (3, 'model')])
        return self._constrain(x, [(0, self._baxes()), (1, 'model')])

    def ssm_state(self, x):
        """[batch, heads, dk, dv] recurrent state."""
        return self._constrain(x, [(0, batch_axes(self.mesh)),
                                   (1, 'model'), (-1, 'model')])

    def btdv(self, x):
        """[batch, seq, heads, dv] linear-attention values: dv over model,
        so every contraction of the chunked scan stays local."""
        return self._constrain(x, [(0, batch_axes(self.mesh)),
                                   (3, 'model')])

    def experts(self, x):
        """[experts, capacity, d] bucketed MoE activations, EP over model."""
        return self._constrain(x, [(0, 'model'), (1, batch_axes(self.mesh))])

    def tokens(self, x):
        """Flat routing tensors [N(, d)] — N over every mesh axis."""
        return self._constrain(x, [(0, all_axes(self.mesh))])


def replicated(mesh) -> Optional[list]:
    """Placements of a replicated value (None mesh -> None)."""
    if mesh is None:
        return None
    return spec_to_placements(P(), mesh)


def spec_to_sharding(mesh, tree_specs):
    """Map a tree (dicts, lists, tuples) of specs to DTensor placements on
    ``mesh`` (None mesh -> None at every leaf)."""
    from .. import tree as tree_util

    def is_spec(s):
        return isinstance(s, P)

    return tree_util.rebuild(
        tree_specs, is_spec,
        (lambda s: None) if mesh is None
        else (lambda s: spec_to_placements(s, mesh)))


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
