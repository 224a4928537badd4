"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and flags, so an edited source
is rebuilt and a current one is loaded as it is.  The build directory is
``build/kernels`` at the root of the checkout (listed in ``.gitignore``);
``REPRO_TORCH_BUILD_DIR`` overrides it.  ``nvcc`` is looked up on ``PATH``,
then under ``CUDA_HOME`` and ``/usr/local/cuda``.

No header of PyTorch is included, so a source compiles in seconds.  Every
pointer and the stream cross the boundary as ``c_void_p``; every C entry
returns ``cudaGetLastError()`` and the wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
NAMES = ('rasterize', 'rc_lookup')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_SECONDS: dict[str, float] = {}   # wall time of each build this process ran


def build_dir() -> pathlib.Path:
    env = os.environ.get('REPRO_TORCH_BUILD_DIR')
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / 'build' / 'kernels'


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and (pathlib.Path(root) / 'bin' / 'nvcc').exists():
            return str(pathlib.Path(root) / 'bin' / 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of repro_torch are '
                       'built at first use and need the CUDA toolkit')


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f'{name}-{digest}.so'


def _start(name: str):
    """Start one nvcc process for ``name``, or return None if it is built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    log = open(out.with_suffix('.log'), 'w')
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                             str(CSRC / f'{name}.cu')],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, log, t0 = job
    rc = proc.wait()
    log.close()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu (exit {rc}):\n'
                           + out.with_suffix('.log').read_text())
    os.replace(tmp, out)


def build_all(names=NAMES) -> dict[str, pathlib.Path]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the library paths."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return {n: _lib_path(n) for n in names}


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (``-Xptxas -v``: registers, shared
    memory and spills of each kernel); empty if it was built elsewhere."""
    log = _lib_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with the argument
    types of its C entries set from ``signatures`` ({entry: (n_ptr, n_int,
    trailing_ptr)}: n_ptr pointers, n_int ints, then trailing pointers)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_all((name,))[name]
    lib = ctypes.CDLL(str(path))
    for entry, (n_ptr, n_int, n_tail) in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * n_tail)
        fn.restype = ctypes.c_int
    err = getattr(lib, f'{name}_error_string')
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f'{name}_error_string')(code).decode()
        raise RuntimeError(f'{what} failed to launch: CUDA error {code} ({msg})')
