"""The op counter: per-rank FLOPs, HBM bytes and collective bytes of one
call, the port's counterpart of the JAX package's ``analysis/hlo_parse.py``.

``hlo_parse`` reads XLA's optimized module text.  Eager PyTorch has no
module text, so this counter reads the op stream at the dispatcher
instead: a ``TorchDispatchMode`` sees every aten and c10d op that runs,
forward and backward, on any device (``meta`` included, where nothing is
computed), and applies ``hlo_parse``'s cost model to each:

  * FLOPs      — exact for matmuls (``mm``, ``bmm``, ``addmm``,
                 ``baddbmm``, ``mv``, ``dot``, convolutions):
                 2 * prod(out) * prod(contracting dims); one FLOP per
                 element of the result for every other op of arithmetic,
                 comparison or reduction; views, factories and random
                 draws cost nothing;
  * HBM bytes  — ``hlo_parse``'s traffic model, where elementwise and
                 reduce chains are assumed fused: a matmul's operands and
                 result, the result of a pure data-movement op (slices,
                 gathers, scatters, ``index_put``, sorts, ``cat``, pads,
                 flips, copies and dtype conversions), and a collective's
                 result;
  * collective bytes — the result of each c10d collective, under
                 ``hlo_parse``'s five keys, and split off as cross-pod when
                 the group's global ranks span more than one pod of
                 ``pod_size``.  The functional collectives that DTensor's
                 redistributions issue (``_c10d_functional``) count the
                 same way, as does the all-to-all that DTensor issues on a
                 CUDA mesh (``_dtensor.shard_dim_alltoall``); their
                 ``wait_tensor`` and autograd wrapper cost nothing.

DTensor.  The counter declines every op whose arguments hold a DTensor
(``NotImplemented``), so DTensor's dispatch runs it and the counter sees
what that dispatch runs on this rank: the op on the local blocks and the
collectives of any redistribution.  The ops that DTensor's sharding
propagation runs on fake tensors to learn an output's global shape are
not part of the program and are not counted.

Eager code runs a loop's body once per trip, so no trip-count multiplier
is needed.  The hand-written kernels launch through ``ctypes`` and never
reach the dispatcher: their launches during the call are read from
``kernels.LAUNCHES`` and listed under ``kernels`` at zero FLOPs and zero
bytes, as ``hlo_parse`` counts a ``custom-call``.  Besides, the counter
tracks the peak of live storage that the call's ops made (freed storages
leave through a weak reference): the ``meta`` counterpart of XLA's
``memory_analysis().temp_size_in_bytes``.  With ``live_at_peak`` it
also lists what is live when that peak is first reached: each storage
labelled by the op that made it, its shape, dtype and phase (``forward``,
or ``backward`` while autograd's engine runs, recomputation included).

Shapes are those of the tensors this rank holds, so every number is
per rank, as ``hlo_parse``'s are per device.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import kernels

# c10d op -> hlo_parse's collective key; the result is the op's first
# argument (in place, or the output buffer)
_COLLECTIVES = {
    'allreduce_': 'all-reduce', 'allreduce_coalesced_': 'all-reduce',
    '_allgather_base_': 'all-gather', 'allgather_': 'all-gather',
    'allgather_coalesced_': 'all-gather',
    'allgather_into_tensor_coalesced_': 'all-gather',
    'reduce_scatter_': 'reduce-scatter',
    '_reduce_scatter_base_': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced_': 'reduce-scatter',
    'alltoall_base_': 'all-to-all', 'alltoall_': 'all-to-all',
    'send': 'collective-permute', 'recv_': 'collective-permute',
}
_POINT_TO_POINT = ('send', 'recv_')

# _c10d_functional and _dtensor op -> hlo_parse's collective key; the
# payload is the op's result.  These ops name their group by a string.
_FUNCTIONAL_COLLECTIVES = {
    'all_reduce': 'all-reduce', 'all_reduce_': 'all-reduce',
    'all_reduce_coalesced': 'all-reduce',
    'all_reduce_coalesced_': 'all-reduce',
    'all_gather_into_tensor': 'all-gather',
    'all_gather_into_tensor_out': 'all-gather',
    'all_gather_into_tensor_coalesced': 'all-gather',
    'reduce_scatter_tensor': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced': 'reduce-scatter',
    'all_to_all_single': 'all-to-all',
    'shard_dim_alltoall': 'all-to-all',     # _dtensor's, on a CUDA mesh
}

_DOT_OPS = {'mm', 'bmm', 'addmm', 'baddbmm', 'mv', 'dot'}
_CONV_OPS = {'convolution', '_convolution', 'convolution_backward'}

# views of their input in torch, but slices in XLA's module: data movement
_SLICE_OPS = {'slice', 'select', 'split', 'split_with_sizes', 'unbind',
              'unsafe_split', 'unsafe_split_with_sizes'}

# pure data movement: zero FLOPs, but real memory traffic (hlo_parse's
# _MOVE_OPS: dynamic-(update-)slice, slice, concatenate, pad, reverse,
# gather, scatter, copy, transpose, sort)
_MOVE_OPS = _SLICE_OPS | {
    'index_select', 'index', 'gather', 'take', 'take_along_dim',
    'embedding', 'embedding_dense_backward', 'masked_select',
    'scatter', 'scatter_', 'scatter_add', 'scatter_add_', 'scatter_reduce',
    'scatter_reduce_', 'index_put', 'index_put_', '_index_put_impl_',
    'index_add', 'index_add_', 'index_copy', 'index_copy_', 'masked_scatter',
    'masked_scatter_', 'slice_scatter', 'select_scatter', 'diagonal_scatter',
    'as_strided_scatter', 'sort', 'argsort', 'topk', 'nonzero',
    'nonzero_static', '_unique2', 'unique_dim', 'cat', 'stack',
    'constant_pad_nd', 'pad', 'reflection_pad1d', 'replication_pad1d',
    'flip', 'roll', 'repeat', 'repeat_interleave', 'clone', 'copy', 'copy_',
    '_to_copy', '_copy_from', '_copy_from_and_resize',
}

# no FLOPs, no bytes (hlo_parse's _ZERO_COST_OPS: parameter, constant,
# broadcast, iota, rng-bit-generator, ...)
_ZERO_COST_OPS = {
    'empty', 'empty_like', 'empty_strided', 'new_empty', 'new_empty_strided',
    'zeros', 'zeros_like', 'new_zeros', 'ones', 'ones_like', 'new_ones',
    'full', 'full_like', 'new_full', 'fill', 'fill_', 'zero_', 'arange',
    'linspace', 'logspace', 'scalar_tensor', 'eye', 'rand', 'rand_like',
    'randn', 'randn_like', 'randint', 'randint_like', 'randperm', 'normal',
    'normal_', 'uniform_', 'bernoulli', 'bernoulli_', 'exponential_',
    'random_', '_efficientzerotensor', 'lift_fresh_copy',
    'detach', 'detach_', '_local_scalar_dense', 'is_nonzero', 'resize_',
    'set_', 'record_stream', '_assert_async', '_assert_tensor_metadata',
    'sym_size', 'sym_stride', 'sym_numel', 'sym_storage_offset',
    '_unsafe_view', '_reshape_alias', 'alias',
}


# the dispatcher's lift of a constant that ``torch.tensor`` made outside it:
# seen off the ``meta`` device only, so not an op of the counted program
_LIFTS = {'lift_fresh'}


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_cost(name: str, args: tuple, out) -> tuple:
    """(FLOPs, bytes) of a matmul: 2 * prod(out) * K, operands + result
    (an ``addmm``'s bias add is elementwise, fused, as in the module)."""
    a, b = args[1:3] if name in ('addmm', 'baddbmm') else args[:2]
    res = _tensors(out)[0]
    return (2 * res.numel() * a.shape[-1],
            _nbytes(a) + _nbytes(b) + _nbytes(res))


def _conv_flops(x, w, out, transposed: bool) -> int:
    """2 * prod(out) * (C_in / groups) * prod(kernel); a transposed
    convolution counted over its input."""
    spatial = x.shape[2:] if transposed else out.shape[2:]
    return 2 * x.shape[0] * math.prod(w.shape) * math.prod(spatial)


def _conv_cost(name: str, args: tuple, out) -> tuple:
    """(FLOPs, bytes) of a convolution, operands + results; the backward
    costs one forward's FLOPs per gradient it computes (input, weight)."""
    res = _tensors(out)
    if name == 'convolution_backward':
        grad_out, x, w = args[:3]
        n_grads = sum(bool(m) for m in args[10][:2])
        flops = n_grads * _conv_flops(x, w, grad_out, bool(args[7]))
        moved = _nbytes(grad_out)
    else:
        x, w = args[:2]
        flops = _conv_flops(x, w, res[0], bool(args[6]))
        moved = 0
    return flops, moved + _nbytes(x) + _nbytes(w) + sum(map(_nbytes, res))


def _is_process_group(obj) -> bool:
    return (isinstance(obj, torch.ScriptObject)
            and obj._type().qualified_name().endswith('c10d.ProcessGroup'))


def _group_ranks(name: str, args: tuple) -> list:
    """The global ranks a c10d op involves: its group's, or for send and
    recv this rank and its peer (the argument after the group).  The op
    carries its group as a boxed ``ProcessGroup``."""
    i = next(i for i, a in enumerate(args) if _is_process_group(a))
    pg = dist.ProcessGroup.unbox(args[i])
    if name in _POINT_TO_POINT:
        return [dist.get_rank(), dist.get_global_rank(pg, int(args[i + 1]))]
    return dist.get_process_group_ranks(pg)


def _functional_group_ranks(args: tuple) -> list:
    """The global ranks of a functional collective's group: its last
    string argument is the group's name (a boxed group is read as is)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            return dist.get_process_group_ranks(_resolve_process_group(a))
        if _is_process_group(a):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    raise ValueError('a functional collective without a group')


def crosses_pod(ranks, pod_size: int) -> bool:
    """Whether the global ``ranks`` span more than one pod of
    ``pod_size``."""
    return len({r // pod_size for r in ranks}) > 1


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is entered (``with
    OpCounter(...):``); ``counts()`` returns ``hlo_parse.analyze_text``'s
    keys plus ``dot_flops``, ``kernels``, ``n_ops`` and ``peak_bytes``,
    and with ``live_at_peak`` also ``live_at_peak``: the (bytes, (op,
    shape, dtype, phase)) of each storage live when ``peak_bytes`` was
    first reached."""

    def __init__(self, pod_size: int = 10 ** 9, entry: str = '',
                 live_at_peak: bool = False):
        super().__init__()
        self.pod_size, self.entry = pod_size, entry
        self.flops = self.dot_flops = self.bytes = 0
        self.coll_bytes = self.coll_bytes_crosspod = 0
        self.coll_counts: dict = {}
        self.n_ops = 0
        self.live = self.peak = 0
        self._storages: dict = {}
        self._launched: dict = {}
        # with live_at_peak: each live storage's (birth, label), the birth
        # of the storage that last raised the peak, and the storages live
        # then that have been freed since
        self._born: dict | None = {} if live_at_peak else None
        self._clock = self._peak_clock = 0
        self._freed_at_peak: list = []

    def __enter__(self):
        self._launched = dict(kernels.LAUNCHES)
        return super().__enter__()

    def __exit__(self, *exc):
        self._launched = {k: v - self._launched.get(k, 0)
                          for k, v in kernels.LAUNCHES.items()
                          if v != self._launched.get(k, 0)}
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # counted as the local ops it runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if (name in _LIFTS or any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(t, FakeTensor) for t in _tensors(out))):
            return out                # DTensor's shape propagation
        self.n_ops += 1
        if func.namespace == 'c10d':
            self._collective(name, args)
        elif func.namespace in ('_c10d_functional', '_dtensor'):
            self._functional_collective(name, args, out)
        elif name in _DOT_OPS or name in _CONV_OPS:
            cost = (_dot_cost if name in _DOT_OPS else _conv_cost)(
                name, args, out)
            self.flops += cost[0]
            self.dot_flops += cost[0]
            self.bytes += cost[1]
        elif name in _MOVE_OPS:
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        elif not (name in _ZERO_COST_OPS or func.is_view):
            res = _tensors(out)
            if res:
                self.flops += res[0].numel()
        self._track(name, out, args, kwargs)
        return out

    def _collective(self, name: str, args: tuple) -> None:
        key = _COLLECTIVES.get(name)
        if key is None:      # barrier, monitored_barrier: no payload
            return
        self._add_collective(key, sum(_nbytes(t) for t in _tensors(args[0])),
                             _group_ranks(name, args))

    def _add_collective(self, key: str, nbytes: int, ranks) -> None:
        self.coll_counts[key] = self.coll_counts.get(key, 0) + 1
        self.coll_bytes += nbytes
        self.bytes += nbytes
        if crosses_pod(ranks, self.pod_size):
            self.coll_bytes_crosspod += nbytes

    def _functional_collective(self, name: str, args: tuple, out) -> None:
        key = _FUNCTIONAL_COLLECTIVES.get(name)
        if key is None:      # wait_tensor, _wrap_tensor_autograd, ...: free
            return
        self._add_collective(key, sum(_nbytes(t) for t in _tensors(out)),
                             _functional_group_ranks(args))

    def _track(self, name: str, out, args, kwargs) -> None:
        """Add the storages that ``out`` made (not those of its inputs:
        views, in-place results) to the live bytes; each leaves when it
        is freed."""
        inputs = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))
                  if t.layout == torch.strided}
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in inputs:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            if self._born is not None:
                self._clock += 1
                phase = ('backward' if torch._C._current_graph_task_id() != -1
                         else 'forward')
                self._born[key] = (self._clock, (name, tuple(t.shape),
                                                 str(t.dtype), phase))
                if self.live > self.peak:
                    self._peak_clock, self._freed_at_peak = self._clock, []
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        n = self._storages.pop(key, 0)
        self.live -= n
        if self._born is not None and key in self._born:
            born, label = self._born.pop(key)
            if born <= self._peak_clock:
                self._freed_at_peak.append((n, label))

    def counts(self) -> dict:
        out = {'flops': self.flops, 'bytes': self.bytes,
               'collective_bytes': self.coll_bytes,
               'collective_bytes_crosspod': self.coll_bytes_crosspod,
               'collective_counts': dict(self.coll_counts),
               'entry': self.entry, 'dot_flops': self.dot_flops,
               'kernels': dict(self._launched), 'n_ops': self.n_ops,
               'peak_bytes': self.peak}
        if self._born is not None:
            out['live_at_peak'] = self._freed_at_peak + [
                (self._storages[k], label)
                for k, (born, label) in self._born.items()
                if born <= self._peak_clock]
        return out


def analyze(fn, *args, pod_size: int = 10 ** 9, live_at_peak: bool = False,
            **kwargs) -> dict:
    """The counts of one call ``fn(*args, **kwargs)`` (``hlo_parse.
    analyze_text``'s keys, ``entry`` the function's qualified name, plus
    ``dot_flops``, ``kernels``, ``n_ops`` and ``peak_bytes``, and
    ``live_at_peak`` where asked)."""
    counter = OpCounter(pod_size, getattr(fn, '__qualname__', repr(fn)),
                        live_at_peak)
    with counter:
        fn(*args, **kwargs)
    return counter.counts()


def saved_bytes(fn, *args, inputs=()) -> tuple:
    """(the bytes of the storages that autograd saves for the backward
    during ``fn(*args)``, each storage once, as ``saved_tensors_hooks``
    sees them, less those of ``inputs``, which the caller holds anyway;
    ``fn``'s result)."""
    held = {x.untyped_storage().data_ptr() for x in inputs}
    seen = {}

    def pack(x):
        st = x.untyped_storage()
        if st.data_ptr() not in held:
            seen[st.data_ptr()] = st.nbytes()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn(*args)
    return sum(seen.values()), out
