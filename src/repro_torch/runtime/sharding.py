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

The port runs one process per rank, every rank the same program.
``distribute_tree`` lays out a tree of values as DTensors by a tree of
specs, the counterpart of the JAX package's ``device_put`` with a
``NamedSharding``: every LM family's parameters, Adam state, batch and
decode state (``models.registry.shard_step_inputs`` and
``shard_decode_inputs``).  On such a layout the model code's ``ShardCtx``
hooks are the counterpart of the JAX package's
``with_sharding_constraint``: a plain tensor passes unchanged, a
``DTensor`` is redistributed to the hook's layout, and DTensor's own
sharding propagation partitions the ops between them as GSPMD does; the
expert-parallel MoE body, a ``shard_map`` in the JAX package, takes each
rank's blocks of its DTensor inputs and runs real collectives
(``runtime.spmd``), and the recurrent cores (the chunked linear
attention, its decode step, the sLSTM scan, a Mamba2 layer's heads) run
on each rank's blocks (``local_map``).  The bodies that change what is
computed (the compressed all-reduce, GPipe, the sharded frame, and the
MoE body when its inputs are replicated) slice their rank's block and
run real collectives.
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
        """``x`` redistributed to the layout that ``assignments`` give its
        shape on the mesh (``with_sharding_constraint``); a plain tensor,
        or any tensor without a mesh, passes unchanged."""
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

    def weights(self, p):
        """A layer's weights (a mapping of name to tensor) with their FSDP
        shards, those over the batch axes, gathered for its matmuls, the
        TP shards over ``model`` kept: ZeRO-3's unshard before a layer
        runs.  No JAX counterpart: GSPMD gathers these weights itself,
        where DTensor would split the matmul's contraction instead and
        leave partial sums to reduce (another summation order, which
        ``flash_attention``'s bfloat16 roundings amplify).  Plain tensors,
        or no mesh: ``p`` as given."""
        from torch.distributed.tensor import DTensor, Replicate
        if self.mesh is None:
            return p
        fsdp = [i for i, a in enumerate(all_axes(self.mesh))
                if a in self._baxes()]
        out = {}
        for k, w in p.items():
            if isinstance(w, DTensor) and any(
                    w.placements[i].is_shard() for i in fsdp):
                pl = list(w.placements)
                for i in fsdp:
                    pl[i] = Replicate()
                w = w.redistribute(w.device_mesh, pl)
            out[k] = w
        return out

    def dv(self, w):
        """[d_model, vocab] unembedding — vocab over model, as the ``btv``
        logits it makes.  No JAX counterpart: GSPMD carries the logits'
        layout back into their matmul, DTensor propagates forward only, so
        a replicated (``dp``) matrix would make every rank compute every
        vocab column and drop most."""
        return self._constrain(w, [(1, 'model')])

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

    def head_dim(self, w):
        """[d_in, heads, head_dim] weight of a projection into heads:
        head_dim over model, as the ``btdv`` values it makes.  No JAX
        counterpart: GSPMD lays out the weight's columns for the values'
        constraint itself."""
        return self._constrain(w, [(2, 'model')])

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


def distribute_tree(tree, spec_tree, mesh):
    """Lay out a tree of values (tensors or numpy arrays in dicts, lists and
    tuples) on ``mesh`` as DTensors, each by the spec at the same place of
    ``spec_tree``: the JAX package's ``device_put`` with a
    ``NamedSharding``.  Every rank holds the whole value and keeps its own
    block, so nothing is sent; each block owns its storage (it is never a
    view of the whole value).  A numpy array goes to the mesh's device, a
    tensor on ``meta`` stays there (the dry run's layout)."""
    from .. import tree as tree_util
    specs = iter(tree_util.leaves(spec_tree, lambda s: isinstance(s, P)))

    def place(x):
        spec = next(specs, None)
        if spec is None:
            raise ValueError('spec_tree has fewer leaves than tree')
        return distribute_like(x, mesh, spec_to_placements(spec, mesh))

    out = tree_util.rebuild(tree, _is_value, place)
    if next(specs, None) is not None:
        raise ValueError('spec_tree has more leaves than tree')
    return out


def _is_value(x) -> bool:
    import numpy as np
    import torch
    return isinstance(x, (torch.Tensor, np.ndarray))


def distribute_like(x, mesh, placements):
    """One value of ``distribute_tree``: ``x`` (a tensor or numpy array
    that every rank holds whole) as a DTensor with ``placements`` on
    ``mesh``, each rank keeping its own block in storage of its own."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = torch.as_tensor(x)
    if not t.is_meta:
        t = t.to(mesh.device_type)
    t = t.detach()
    dt = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage()._cdata == t.untyped_storage()._cdata:
        dt = DTensor.from_local(local.clone(), mesh, dt.placements,
                                shape=dt.shape, stride=dt.stride())
    return dt


def as_dtensor_like(t, ref, placements=None):
    """``t``, a plain tensor that every rank holds whole, on the mesh of
    ``ref`` when ``ref`` is a DTensor: replicated, or by ``placements``
    (each rank keeps its own block; nothing is sent).  ``t`` itself when
    ``ref`` is plain.  For the constants the model code makes (positions,
    masks, rotary frequencies): DTensor ops take no plain tensor of
    rank >= 1 beside a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    if placements is None:
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
    return distribute_like(t, mesh, placements)


def axis_placements(ref, dim: int) -> list:
    """The placements of a 1-D tensor laid out as the DTensor ``ref``'s
    dimension ``dim`` (sharded where that dimension is, else
    replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= ref.ndim
    return [Shard(0) if isinstance(p, Shard) and p.dim == dim
            else Replicate() for p in ref.placements]


def local_range(x, dim: int) -> tuple:
    """This rank's ``[start, stop)`` along dimension ``dim`` of ``x``: of
    a DTensor, the global positions of its block (DTensor's split, as
    ``torch.chunk``'s, nested in the mesh's order); of a plain tensor, or
    where no mesh dimension shards ``dim``, the whole range."""
    from torch.distributed.tensor import DTensor, Shard
    dim %= x.ndim
    start, size = 0, x.shape[dim]
    if not isinstance(x, DTensor):
        return start, size
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            lo = min(coord[i] * chunk, size)
            start, size = start + lo, min(chunk, size - lo)
    return start, start + size


def unshard_dims(x, dims):
    """``x`` with its tensor dimensions ``dims`` gathered whole on every
    rank (the other dimensions keep their layout); a plain tensor passes
    unchanged.  An explicit layout where the next ops would otherwise
    gather the same dimension once each."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def reduce_partials(x):
    """``x`` with every pending reduction (``Partial`` placements, masked
    ones included) carried out, its shards kept; a plain tensor passes
    unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def to_replicated(x):
    """``x`` whole on every rank (Shard and Partial placements gathered or
    reduced), as the JAX package's replicated ``out_shardings``; a plain
    tensor passes unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate()] * x.device_mesh.ndim
    return x if tuple(x.placements) == tuple(pl) else x.redistribute(
        x.device_mesh, pl)


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
