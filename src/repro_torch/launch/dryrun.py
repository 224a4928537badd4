"""Production-mesh dry run: count every (arch x shape x mesh) cell on the
``meta`` device, the counterpart of the JAX package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell for 256 or 512 forced host
devices.  The port has no compiler to ask, so it runs the cell's step once
in this process as rank 0 of a ``fake`` process group of 256 (``single``)
or 512 (``multi``) ranks, on a production mesh over it
(``launch.mesh.make_production_mesh``), with every tensor on the ``meta``
device: nothing is allocated and nothing is computed.  The step is the
real one (``registry.make_train_step`` for train shapes, the prefill or
decode step otherwise, ``render_dist``'s frame for the render cell), so
its collectives run on the fake group's sub-groups.  For each cell it
records:

  * ``memory_analysis``: the bytes of what goes in (parameters, optimizer
    state, batch, decode state) and comes out, and the peak of live
    storage above them (the op counter's ``peak_bytes``);
  * ``cost_analysis``: ``torch.utils.flop_counter.FlopCounterMode``'s
    total for the same call, a check on the counter's matmul FLOPs;
  * the op counter's per-rank FLOPs, HBM bytes and collective bytes
    (``analysis.op_count``) and the three-term roofline on an H100
    (``analysis.roofline``);
  * with ``live_at_peak`` (``--live-at-peak N`` prints the N largest),
    what is live at that peak: the storages grouped by the op that made
    them, shape, dtype and phase (``forward``, or ``backward``, where
    remat's recomputation runs), largest total first.

Every LM cell (smollm-360m, yi-34b, command-r-35b, nemotron-4-15b,
chameleon-34b; granite-moe-1b-a400m and llama4-maverick-400b-a17b under
the recipe ``ep``; xlstm-1.3b and zamba2-1.2b under ``ssm``; whisper-base
under ``dp``) at every shape it runs, ``long_500k`` included, counts the
partitioned program: parameters, Adam state, batch and decode state are
laid out as DTensors by the recipe's specs (``registry.
shard_step_inputs`` and ``shard_decode_inputs``, the JAX package's
``in_shardings``; ``long_500k``'s decode state by the long-context rule),
the model code's ``ShardCtx`` hooks redistribute its activations, and
each rank computes and holds its own block (a decode rank its rows'
block of the K/V caches' sequence, at ``long_500k`` its block of the
sequence over ``data`` and of the heads over ``model``, of the mLSTM
state's dk, of the SSD state's heads; an MoE rank its block of the
experts, their rows over ``data``, running the expert-parallel body on
its tokens; a Mamba2 rank its heads; a whisper rank its rows and, in
attention, its heads).  The render cell runs the sharded frame.  Each
roofline row's ``note`` names the program it counted (after the
overrides, if any).  The counts are what one rank really runs.

Run one cell:     python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
Run everything:   python -m repro_torch.launch.dryrun --all   (subprocess per cell)
Print the table:  python -m repro_torch.launch.dryrun --table
Results land in   build/dryrun/<arch>__<shape>__<mesh>.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..analysis import op_count
from ..analysis import roofline as rl
from ..analysis.flops import model_flops
from ..configs import ALL_LM_ARCHS, get_config
from ..configs.base import SHAPES, shape_applicable
from ..models import registry
from ..optim import adam
from ..tree import leaves
from .mesh import make_production_mesh, production_shape

OUT_DIR = Path(__file__).resolve().parents[3] / 'build' / 'dryrun'

RENDER_SHAPES = ('render_1080p',)   # the paper-native lumina-3dgs cell
MESH_RANKS = {'single': 256, 'multi': 512}


def _opt_overrides(cfg, opt: str):
    """Apply comma-separated perf-iteration overrides (k=v,k=v)."""
    if not opt:
        return cfg
    for item in opt.split(','):
        k, _, v = item.partition('=')
        k = k.strip()
        if not k:
            continue
        field_types = {f.name: f.type for f in dataclasses.fields(cfg)}
        if k not in field_types:
            raise ValueError(f'unknown override {k!r} for {cfg.name}')
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            val = v.lower() in ('1', 'true', 'yes')
        elif isinstance(cur, int):
            val = int(v)
        elif isinstance(cur, float):
            val = float(v)
        else:
            val = v
        cfg = dataclasses.replace(cfg, **{k: val})
    return cfg


# ---------------------------------------------------------------------------
# The fake world: one process as rank 0 of the production mesh
# ---------------------------------------------------------------------------

def init_fake_world(world_size: int) -> None:
    """Start a ``fake`` process group of ``world_size`` ranks with this
    process as rank 0: its collectives return at once and move nothing.
    Raises when this torch has no ``fake`` backend (the dry run needs the
    production mesh's size, and never runs on a smaller one)."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError('the dry run needs torch.distributed, which this '
                           'torch build lacks')
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.distributed's 'fake' backend "
            '(torch.testing._internal.distributed.fake_pg), which this '
            f'torch build lacks: {e}') from e
    dist.init_process_group('fake', store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# Cell builders: (step, meta arguments, model FLOPs)
# ---------------------------------------------------------------------------

def build_lm_cell(arch: str, shape_name: str, mesh, opt: str = ''):
    cfg = _opt_overrides(get_config(arch), opt)
    shape = SHAPES[shape_name]
    long_context = shape.name == 'long_500k'
    ctx = registry.make_ctx(mesh, cfg, long_context=long_context)
    tp = registry.tp_of(mesh, cfg)

    params = registry.abstract_params(cfg, tp)
    batch = registry.input_specs(cfg, shape)
    split = mesh is not None

    if shape.kind == 'decode':
        # one new token at the last position of a full cache
        state = registry.abstract_decode_state(
            cfg, shape.global_batch, shape.seq_len, tp)
        token = batch['token']
        if split:
            params, state, token = registry.shard_decode_inputs(
                cfg, mesh, params, state, token, long_context=long_context)
        fn = registry.make_decode_step(cfg, ctx)
        return fn, (params, token, state, shape.seq_len - 1), model_flops(
            cfg, shape)

    if split:
        params, _, batch = registry.shard_step_inputs(cfg, mesh, params,
                                                      batch=batch)
    if shape.kind == 'train':
        step, acfg = registry.make_train_step(cfg, ctx)
        opt_state = adam.init(list(params.parameters()), acfg)
        fn, args = step, (params, opt_state, batch)
    else:
        fn, args = registry.make_prefill(cfg, ctx), (params, batch)
    return fn, args, model_flops(cfg, shape)


def build_render_cell(shape_name: str, mesh, opt: str = ''):
    """The paper-native workload: one LuminSys serve frame, distributed.

    Gaussians shard over the batch axes (projection is embarrassingly
    parallel), tiles over 'model' for rasterization: the cluster-scale
    analogue of the paper's GPU(sort) / NRU(raster) split.
    """
    from ..core import render_dist
    cfg = get_config('lumina-3dgs')
    if opt:
        cfg = _opt_overrides(cfg, opt)
    return render_dist.build_dryrun_cell(cfg, mesh, shape_name)


# ---------------------------------------------------------------------------
# One cell: count -> analyze -> save
# ---------------------------------------------------------------------------

def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``, a
    module's parameters and buffers included; of a DTensor, this rank's
    block."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for x in leaves(tree, lambda x: isinstance(x, (torch.Tensor,
                                                   torch.nn.Module))):
        for t in ([x] if isinstance(x, torch.Tensor)
                  else [*x.parameters(), *x.buffers()]):
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def program_of(arch: str) -> str:
    """Which program a cell counts: ``partitioned`` (an LM's DTensor
    layouts) or ``frame`` (the render cell's sharded frame)."""
    return 'frame' if arch == 'lumina-3dgs' else 'partitioned'


def dry_run_mesh(mesh_kind: str, program: str):
    """The production mesh over the fake world.  A partitioned cell's mesh
    has the card's device type, ``cuda``, and needs no card (the fake group
    moves nothing, every tensor lies on ``meta``): the type picks
    DTensor's redistributions, the card's all-to-all where a CPU mesh
    falls back to an all-gather and a chunk.  The render cell's code
    places plain tensors on the mesh's device, so its mesh is the
    CPU's."""
    multi = mesh_kind == 'multi'
    if program != 'partitioned':
        return make_production_mesh(multi_pod=multi, device='cpu')
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi)
    return init_device_mesh('cuda', shape, mesh_dim_names=axes)


def stem_of(arch: str, shape_name: str, mesh_kind: str, opt: str = '') -> str:
    return f'{arch}__{shape_name}__{mesh_kind}' + (
        f'__{_slug(opt)}' if opt else '')


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             opt: str = '', out_dir: Path = OUT_DIR,
             live_at_peak: bool = False) -> dict:
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    chips = MESH_RANKS[mesh_kind]
    init_fake_world(chips)
    try:
        program = program_of(arch)
        mesh = dry_run_mesh(mesh_kind, program)
        if arch == 'lumina-3dgs':
            fn, args, mf = build_render_cell(shape_name, mesh, opt)
        else:
            fn, args, mf = build_lm_cell(arch, shape_name, mesh, opt)
        arg_bytes = _tensor_bytes(args)
        flop_mode = FlopCounterMode(display=False)
        counter = op_count.OpCounter(rl.POD_SIZE, f'{arch}/{shape_name}',
                                     live_at_peak)
        t0 = time.time()
        # the counter enters last, so it sees each op before
        # FlopCounterMode may decompose it
        with flop_mode, counter:
            out = fn(*args)
        t_count = time.time() - t0
    finally:
        dist.destroy_process_group()
    counts = counter.counts()

    mem = {'argument_size_in_bytes': arg_bytes,
           'output_size_in_bytes': _tensor_bytes(out),
           'temp_size_in_bytes': counts['peak_bytes'],
           'alias_size_in_bytes': 0, 'generated_code_size_in_bytes': 0}
    # the row's note: the overrides, and the program counted
    note = '; '.join(x for x in (opt, program) if x)
    roof = rl.from_counts(arch, shape_name, mesh_kind, chips, counts,
                          model_flops=mf, memory=mem, note=note)
    rec = {
        'arch': arch, 'shape': shape_name, 'mesh': mesh_kind,
        'chips': chips, 'opt': opt,
        'count_s': round(t_count, 2),
        'memory_analysis': mem,
        'cost_analysis': {'flops': float(flop_mode.get_total_flops())},
        'roofline': roof.row(),
        'n_ops': counts['n_ops'],
    }
    if live_at_peak:
        rec['live_at_peak'] = group_live(counts['live_at_peak'])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f'{stem_of(arch, shape_name, mesh_kind, opt)}.json',
              'w') as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def group_live(live: list) -> list:
    """The op counter's ``live_at_peak`` storages grouped by (op, shape,
    dtype, phase), largest total first."""
    groups: dict = {}
    for n, label in live:
        g = groups.setdefault(label, [0, 0])
        g[0] += n
        g[1] += 1
    return [{'op': k[0], 'shape': list(k[1]), 'dtype': k[2], 'phase': k[3],
             'bytes': n, 'count': c}
            for k, (n, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])]


def _slug(s: str) -> str:
    return ''.join(c if c.isalnum() else '-' for c in s)[:48]


def all_cells(include_render: bool = True):
    cells = []
    for arch in ALL_LM_ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if not shape_applicable(cfg, shape):
                continue
            cells.append((arch, sname))
    if include_render:
        for sname in RENDER_SHAPES:
            cells.append(('lumina-3dgs', sname))
    return cells


def run_all(mesh_kinds=('single', 'multi'), *, opt: str = '',
            jobs: int = 1, timeout: int = 7200, force: bool = False,
            include_render: bool = True) -> None:
    """Drive every cell in a subprocess (a fresh fake world per cell; crash
    isolation)."""
    work = []
    for arch, sname in all_cells(include_render):
        for mk in mesh_kinds:
            if not force and (OUT_DIR / f'{stem_of(arch, sname, mk, opt)}'
                              '.json').exists():
                continue
            work.append((arch, sname, mk))
    print(f'{len(work)} cells to run')
    procs: list = []
    results = {'ok': 0, 'fail': 0}
    log_dir = OUT_DIR / 'logs'
    log_dir.mkdir(parents=True, exist_ok=True)

    def launch(arch, sname, mk):
        log = open(log_dir / f'{stem_of(arch, sname, mk, opt)}.log', 'w')
        cmd = [sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
               arch, '--shape', sname, '--mesh', mk]
        if opt:
            cmd += ['--opt', opt]
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        return (p, log, time.time(), (arch, sname, mk))

    queue = list(work)
    while queue or procs:
        while queue and len(procs) < jobs:
            procs.append(launch(*queue.pop(0)))
        time.sleep(5)
        still = []
        for p, log, t0, cell in procs:
            if p.poll() is None:
                if time.time() - t0 > timeout:
                    p.kill()
                    p.wait()
                    print(f'TIMEOUT {cell}')
                    results['fail'] += 1
                    log.close()
                else:
                    still.append((p, log, t0, cell))
            else:
                ok = p.returncode == 0
                results['ok' if ok else 'fail'] += 1
                dt = time.time() - t0
                print(f'{"OK  " if ok else "FAIL"} {cell} ({dt:.0f}s)')
                log.close()
        procs = still
    print(f"done: {results['ok']} ok, {results['fail']} failed")


def collect_table() -> list[dict]:
    rows = []
    for f in sorted(OUT_DIR.glob('*.json')):
        with open(f) as fh:
            rec = json.load(fh)
        rows.append(rec['roofline'] | {
            'count_s': rec['count_s'],
            'temp_bytes': rec['memory_analysis'].get('temp_size_in_bytes', 0),
        })
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch')
    ap.add_argument('--shape')
    ap.add_argument('--mesh', choices=('single', 'multi'), default='single')
    ap.add_argument('--opt', default='', help='cfg overrides, k=v,k=v')
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--force', action='store_true')
    ap.add_argument('--jobs', type=int, default=1)
    ap.add_argument('--timeout', type=int, default=7200)
    ap.add_argument('--table', action='store_true',
                    help='print the collected roofline table and exit')
    ap.add_argument('--live-at-peak', type=int, default=0, metavar='N',
                    help="print the N largest groups of what is live at "
                         "the cell's peak")
    args = ap.parse_args()

    if args.table:
        print(rl.fmt_table(collect_table()))
        return
    if args.all:
        run_all(opt=args.opt, jobs=args.jobs, timeout=args.timeout,
                force=args.force)
        return
    if not (args.arch and args.shape):
        ap.error('--arch and --shape, or --all, are required')
    rec = run_cell(args.arch, args.shape, args.mesh, opt=args.opt,
                   live_at_peak=args.live_at_peak > 0)
    print(json.dumps({k: rec[k] for k in
                      ('arch', 'shape', 'mesh', 'count_s', 'n_ops')},
                     indent=1))
    print('memory_analysis:', rec['memory_analysis'])
    print('cost_analysis:', rec['cost_analysis'])
    r = rec['roofline']
    print(f"roofline: compute={rl.fmt_seconds(r['t_compute_s'])} "
          f"memory={rl.fmt_seconds(r['t_memory_s'])} "
          f"collective={rl.fmt_seconds(r['t_collective_s'])} "
          f"bound={r['bottleneck']} useful={r['useful_ratio']:.2f} "
          f"roofline%={100 * r['roofline_fraction']:.1f} ({r['note']})")
    if args.live_at_peak:
        live = rec['live_at_peak']
        total = sum(g['bytes'] for g in live)
        print(f"live at the peak: {total / 1e9:.3f} GB in "
              f"{sum(g['count'] for g in live)} storages; largest groups "
              '(op, shape, dtype, phase):')
        for g in live[:args.live_at_peak]:
            print(f"  {g['bytes'] / 1e9:8.3f} GB "
                  f"{100 * g['bytes'] / total:5.1f} %  x{g['count']:<5} "
                  f"{g['op']} {g['shape']} {g['dtype']} {g['phase']}")


if __name__ == '__main__':
    main()
