"""The port's dry-run peak a rank beside the JAX package's
``memory_analysis`` for a list of cells, on the CPU.

    python3 tools/dryrun_peaks.py [--src DIR] [--jax] [--jobs N]
                                  [--cells ARCH:SHAPE:MESH[:OPT] ...]

For each cell it runs ``repro_torch.launch.dryrun.run_cell(...,
live_at_peak=True)`` of the ``repro_torch`` package under ``DIR``
(default: this checkout's ``src``; a parent commit's ``src``, unpacked
elsewhere, counts the parent) in a subprocess of its own, and prints one
JSON line: the argument and peak bytes a rank, the FLOPs a rank,
``useful_ratio``, the collective bytes a rank, the count's seconds, and
the 20 largest groups of what is live at the peak (op, shape, dtype, phase, bytes, count).  With
``--jax`` it also compiles the cell with the JAX package's
``repro.launch.dryrun.run_cell`` in a subprocess (that module fixes 512
host devices at import), its record written to a temporary directory,
and prints its ``memory_analysis`` in the same line.  ``--jobs`` runs
that many cells at once (each count holds its op counter's records in
memory: keep it small).  The default cells are the ``train_4k`` cells of
the single mesh whose backward the chunk loops' checkpoints change.

Nothing is computed on a device: the port counts on ``meta`` tensors.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = ('smollm-360m:train_4k:single',
         'smollm-360m:train_4k:single:n_layers=2',
         'granite-moe-1b-a400m:train_4k:single',
         'whisper-base:train_4k:single', 'zamba2-1.2b:train_4k:single',
         'xlstm-1.3b:train_4k:single',
         'xlstm-1.3b:train_4k:single:n_layers=8')

PORT = '''
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from repro_torch.analysis import roofline as rl
from repro_torch.launch import dryrun
arch, shape, mesh, opt = json.loads(sys.argv[2])
with tempfile.TemporaryDirectory() as d:
    rec = dryrun.run_cell(arch, shape, mesh, opt=opt, out_dir=Path(d),
                          live_at_peak=True)
row = rec['roofline']
print(json.dumps({
    'args': rec['memory_analysis']['argument_size_in_bytes'],
    'peak': rec['memory_analysis']['temp_size_in_bytes'],
    'flops': row['hlo_flops_total'] / rec['chips'],
    'matmul_flops': rec['cost_analysis']['flops'],
    'useful_ratio': row['useful_ratio'],
    'collective_bytes': row['t_collective_s'] * rl.NVLINK_BYTES_PER_S,
    'n_ops': rec['n_ops'],
    'count_s': rec['count_s'], 'live_at_peak': rec['live_at_peak'][:20],
    'live_total': sum(g['bytes'] for g in rec['live_at_peak'])}))
'''

JAX = '''
import json, sys, tempfile
from pathlib import Path
from repro.launch import dryrun
arch, shape, mesh, opt = json.loads(sys.argv[1])
with tempfile.TemporaryDirectory() as d:
    rec = dryrun.run_cell(arch, shape, mesh, opt=opt, out_dir=Path(d))
print(json.dumps(rec['memory_analysis']))
'''


def _last_json(args, env) -> dict:
    run = subprocess.run(args, capture_output=True, text=True, env=env,
                         cwd=ROOT)
    if run.returncode:
        return {'error': run.stderr[-1500:]}
    return json.loads(run.stdout.strip().splitlines()[-1])


def count(cell: str, src: Path, with_jax: bool) -> dict:
    arch, shape, mesh, *opt = cell.split(':')
    spec = json.dumps([arch, shape, mesh, opt[0] if opt else ''])
    t0 = time.time()
    out = {'cell': cell, 'src': str(src),
           'port': _last_json([sys.executable, '-c', PORT, str(src), spec],
                              dict(os.environ))}
    if with_jax:
        env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'),
                   JAX_PLATFORMS='cpu')
        out['jax'] = _last_json([sys.executable, '-c', JAX, spec], env)
    out['seconds'] = time.time() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--src', type=Path, default=ROOT / 'src')
    ap.add_argument('--jax', action='store_true')
    ap.add_argument('--jobs', type=int, default=1)
    ap.add_argument('--cells', nargs='*', default=CELLS)
    args = ap.parse_args()
    src = args.src.resolve()
    ok = True
    with ThreadPoolExecutor(args.jobs) as pool:
        for out in pool.map(lambda c: count(c, src, args.jax), args.cells):
            print(json.dumps(out), flush=True)
            ok = ok and 'error' not in out['port'] and 'error' not in out.get(
                'jax', {})
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
