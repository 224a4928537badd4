"""Checkpointing: atomic, async, keep-K, auto-resume.

  * **Atomic**: a checkpoint is written into ``step_<n>.tmp/`` (one ``npz``
    shard plus a JSON manifest, each fsync'd) and ``rename()``d to
    ``step_<n>/`` only when complete, so ``latest()`` only ever sees whole
    checkpoints.
  * **Async**: ``save()`` copies every tensor and array to host memory (the
    only synchronous part: the caller may mutate its state in place as soon
    as it returns) and hands serialization to a background thread; at most
    one save is in flight.
  * **Keep-K**: older checkpoints are deleted after a successful save;
    ``keep_every`` marks permanent ones.
  * **Auto-resume**: ``restore_latest()`` picks the newest checkpoint that
    loads, falling back one step at a time past unreadable ones.

A tree is walked in ``repro_torch.tree``'s order: dicts (in sorted key
order), dataclasses (in field order), tuples and lists are containers;
tensors and numpy arrays are the leaves that are saved; anything else
(ints, strings, None) is structure, which a load takes from the template
it is given.  The manifest stores the leaf names and a checksum of each
shard.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import children, rebuild


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten_with_names(tree: Any, path: str = '') -> tuple[list, list]:
    """(names, leaves) of the tensor and numpy-array leaves of ``tree``."""
    if _is_leaf(tree):
        return [path], [tree]
    names, leaves = [], []
    for key, child in children(tree):
        n, lv = _flatten_with_names(child, path + key)
        names += n
        leaves += lv
    return names, leaves


def _rebuild(template: Any, leaves, device=None) -> Any:
    """``template`` with its leaves taken in order from the iterator
    ``leaves`` (numpy arrays): a tensor leaf becomes a tensor on ``device``
    (the template's own by default), a numpy leaf stays numpy."""
    def load(old):
        if isinstance(old, np.ndarray):
            return next(leaves)
        t = torch.from_numpy(next(leaves))
        if old.dtype == torch.bfloat16 and t.dtype == torch.int16:
            # saved as its bits (``_host_copy``)
            t = t.view(torch.bfloat16)
        return t.to(old.device if device is None else device)
    return rebuild(template, _is_leaf, load)


def _host_copy(x) -> np.ndarray:
    """A numpy copy that shares no memory with ``x`` (a CPU tensor's
    ``.numpy()`` would).  numpy has no bfloat16: such a tensor is copied as
    its bits, int16, and ``_rebuild`` views them as bfloat16 again."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to('cpu', copy=True)
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.array(x, copy=True)


def _checksum(arrays: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        # the first MB of each array: cheap, and catches truncation
        h.update(a.tobytes()[:1 << 20])
    return h.hexdigest()


def _safe(name: str) -> str:
    return name.replace('/', '__')


def _write(path: Path, names: list, arrays: list, *, step: int,
           extra: Optional[dict]) -> Path:
    """Write host arrays as ``path/step_<step>`` through the atomic
    ``.tmp`` rename."""
    final = path / f'step_{step:010d}'
    tmp = path / f'step_{step:010d}.tmp'
    tmp.mkdir(parents=True, exist_ok=True)
    host_arrays = dict(zip(names, arrays))
    with open(tmp / 'host0.npz', 'wb') as f:
        np.savez(f, **{_safe(n): a for n, a in host_arrays.items()})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        'step': step,
        'num_hosts': 1,
        'names': names,
        'checksum': {'host0': _checksum(host_arrays)},
        'time': time.time(),
        'extra': extra or {},
    }
    with open(tmp / 'manifest.json', 'w') as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)    # atomic publish
    return final


def save_checkpoint(path: str | Path, tree: Any, *, step: int,
                    extra: Optional[dict] = None) -> Path:
    """Synchronous save of ``tree`` under ``path/step_<step>``."""
    names, leaves = _flatten_with_names(tree)
    return _write(Path(path), names, [_host_copy(x) for x in leaves],
                  step=step, extra=extra)


def load_checkpoint(path: str | Path, tree_like: Any, *, step: int,
                    device=None) -> tuple:
    """Load ``step`` into the structure of ``tree_like``, its tensors on
    ``device`` (each template tensor's own device by default).  Returns
    ``(tree, extra)``; raises ``ValueError`` when the leaf names, a shape
    or a shard's checksum differ from what was saved."""
    path = Path(path) / f'step_{step:010d}'
    with open(path / 'manifest.json') as f:
        manifest = json.load(f)
    names, leaves = _flatten_with_names(tree_like)
    if names != manifest['names']:
        raise ValueError('checkpoint structure mismatch: '
                         f'{len(names)} leaves now vs '
                         f'{len(manifest["names"])} saved')
    unsafe = {_safe(n): n for n in manifest['names']}
    arrays: dict = {}
    for hf in sorted(path.glob('host*.npz')):
        host_arrays: dict = {}
        with np.load(hf) as z:
            for k in z.files:
                host_arrays[unsafe.get(k, k)] = z[k]
        want = manifest.get('checksum', {}).get(hf.stem)
        if want is not None and _checksum(host_arrays) != want:
            raise ValueError(f'checksum mismatch in {hf.name}: '
                             'shard bytes corrupted since save')
        arrays.update(host_arrays)
    out = []
    for name, leaf in zip(names, leaves):
        a = arrays.get(name)
        if a is None:
            raise ValueError(f'checkpoint missing leaf {name}')
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f'shape mismatch for {name}: '
                             f'{a.shape} saved vs {tuple(leaf.shape)} '
                             'expected')
        out.append(a)
    return _rebuild(tree_like, iter(out), device), manifest.get('extra', {})


class CheckpointManager:
    """Async keep-K checkpoint manager with auto-resume."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 keep_every: int = 0, metrics=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_every = keep_every
        if metrics is None:
            from ..obs.metrics import Registry
            metrics = Registry()
        self.metrics = metrics
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- discovery ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for d in self.dir.glob('step_*'):
            if d.is_dir() and not d.name.endswith('.tmp') \
                    and (d / 'manifest.json').exists():
                steps.append(int(d.name.split('_')[1]))
        return sorted(steps)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest_extra(self, step: int) -> Optional[dict]:
        """The ``extra`` metadata a step was saved with, without loading any
        arrays (a restore builds its shape template from it).  None when the
        manifest is missing or unreadable."""
        try:
            with open(self.dir / f'step_{step:010d}' / 'manifest.json') as f:
                return json.load(f).get('extra', {})
        except (OSError, ValueError):
            return None

    # -- save ---------------------------------------------------------------
    def save(self, tree: Any, *, step: int,
             extra: Optional[dict] = None) -> None:
        """Copy ``tree`` to host memory now, serialize in the background."""
        self.wait()   # at most one in-flight save
        self._raise_error()
        names, leaves = _flatten_with_names(tree)
        arrays = [_host_copy(x) for x in leaves]

        def work():
            try:
                _write(self.dir, names, arrays, step=step, extra=extra)
                self._gc()
            except BaseException as e:   # surfaced on next save()/wait()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def _raise_error(self) -> None:
        if self._error:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _gc(self) -> None:
        steps = self.all_steps()
        protected = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_every:
            protected |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in protected:
                try:
                    shutil.rmtree(self.dir / f'step_{s:010d}')
                except OSError as e:
                    self.metrics.counter(
                        'ckpt.gc_errors',
                        'failed checkpoint garbage collections').inc()
                    warnings.warn(f'checkpoint GC failed for step {s}: {e}',
                                  RuntimeWarning, stacklevel=2)

    # -- restore ------------------------------------------------------------
    def restore_latest(self, tree_like: Any) -> Optional[tuple]:
        """``(tree, step, extra)`` of the newest loadable checkpoint, or
        None."""
        self.wait()
        for step in reversed(self.all_steps()):
            try:
                tree, extra = load_checkpoint(self.dir, tree_like, step=step)
                return tree, step, extra
            except Exception as e:   # corrupt / partial: fall back one step
                self.metrics.counter(
                    'ckpt.restore_fallback',
                    'checkpoints skipped as unreadable at restore').inc()
                warnings.warn(f'checkpoint step {step} unreadable ({e}); '
                              'falling back to previous',
                              RuntimeWarning, stacklevel=2)
        return None
