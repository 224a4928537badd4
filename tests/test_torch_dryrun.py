"""The port's dry run (``launch.dryrun``), the registry's dry-run inputs
and the render walk's ``meta`` branch, against the JAX package, on the
CPU.

  * ``registry.input_specs`` and ``abstract_decode_state`` give JAX's tree,
    shape for shape and dtype for dtype, for every applicable (arch x
    shape) pair (the decode state at the production mesh's tp of 16);
  * ``_opt_overrides`` and ``all_cells`` equal the JAX package's, which a
    subprocess reports: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
    host devices when it is imported, so it never enters this process;
  * one subprocess dry run of smollm-360m cut to 2 layers at ``train_4k``
    on the single mesh of 256 fake ranks: the record has JAX's keys (with
    ``count_s`` for ``lower_s`` / ``compile_s`` and ``n_ops`` for
    ``hlo_chars``), the roofline row JAX's, the argument bytes the
    parameters plus the moments plus this rank's block of the batch (the
    partitioned program), and ``--table`` prints it;
  * the render walk on a small scene (1,000 Gaussians at 64x48): on
    ``meta`` it takes exactly capacity / chunk trips and counts at least
    what the CPU walk counts (as much where every CPU tile runs to its
    last chunk); projection, sort and gather count the same on both.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.analysis import roofline as jrl
from repro.configs import ALL_LM_ARCHS, get_config as jget
from repro.configs.base import SHAPES as JSHAPES, shape_applicable
from repro.models import registry as jreg

from repro_torch.analysis import op_count
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core import rasterize as trast
from repro_torch.core import render_dist as trd
from repro_torch.core.pipeline import LuminaConfig
from repro_torch.core.projection import project
from repro_torch.core.sorting import sort_scene
from repro_torch.core.tiling import gather_tile_features
from repro_torch.data.scenes import structured_scene
from repro_torch.data.trajectory import orbit_trajectory
from repro_torch.launch import dryrun as tdry
from repro_torch.models import registry as treg
from torch_serve_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in ALL_LM_ARCHS for s, shape in JSHAPES.items()
         if shape_applicable(jget(a), shape)]
DECODE_PAIRS = [(a, s) for a, s in PAIRS if JSHAPES[s].kind == 'decode']
TP = 16                  # the production mesh's model axis
OVERRIDES = ('', 'n_layers=2', 'remat=false,d_ff=512', 'dtype=float32',
             'norm_eps=1e-6, capacity_factor=2, act=gelu')
RENDER_SHAPES = ('render_1080p',)   # src/repro/launch/dryrun.py
# src/repro/launch/dryrun.py's run_cell record
JAX_RECORD_KEYS = {'arch', 'shape', 'mesh', 'chips', 'opt', 'lower_s',
                   'compile_s', 'memory_analysis', 'cost_analysis',
                   'roofline', 'hlo_chars'}
MEMORY_KEYS = {'argument_size_in_bytes', 'output_size_in_bytes',
               'temp_size_in_bytes', 'alias_size_in_bytes',
               'generated_code_size_in_bytes'}
SCENE, WIDTH, HEIGHT, CHUNK = 1000, 64, 48, 64


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _same_tree(jtree, ttree):
    jl, tl = _flat(jtree), _flat(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert t.dtype == getattr(torch, str(j.dtype)), path
        assert t.device.type == 'meta', path


@pytest.mark.parametrize('arch,shape', PAIRS)
def test_input_specs_match_jax(arch, shape):
    _same_tree(jreg.input_specs(jget(arch), JSHAPES[shape]),
               treg.input_specs(tget(arch), TSHAPES[shape]))


@pytest.mark.parametrize('arch,shape', DECODE_PAIRS)
def test_abstract_decode_state_matches_jax(arch, shape):
    sh = JSHAPES[shape]
    _same_tree(jreg.abstract_decode_state(jget(arch), sh.global_batch,
                                          sh.seq_len, TP),
               treg.abstract_decode_state(tget(arch), sh.global_batch,
                                          sh.seq_len, TP))


JAX_ORACLE = '''
import dataclasses, json, sys
from repro.configs import get_config
from repro.launch import dryrun
out = {'cells': dryrun.all_cells(), 'render_shapes': dryrun.RENDER_SHAPES,
       'overrides': {}}
for opt in json.loads(sys.argv[1]):
    try:
        cfg = dryrun._opt_overrides(get_config('smollm-360m'), opt)
        out['overrides'][opt] = dataclasses.asdict(cfg)
    except ValueError as e:
        out['overrides'][opt] = 'ValueError: ' + str(e)
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def jax_dryrun():
    """What the JAX package's dry-run module reports, from a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'), JAX_PLATFORMS='cpu')
    opts = list(OVERRIDES) + ['no_such_field=1']
    out = subprocess.run([sys.executable, '-c', JAX_ORACLE, json.dumps(opts)],
                         capture_output=True, text=True, env=env, timeout=300,
                         check=True)
    return json.loads(out.stdout.splitlines()[-1])


def test_all_cells_match_jax(jax_dryrun):
    got = [list(c) for c in tdry.all_cells()]
    assert got == jax_dryrun['cells']
    assert list(tdry.RENDER_SHAPES) == jax_dryrun['render_shapes'] == \
        list(RENDER_SHAPES)
    assert got == [list(p) for p in PAIRS] + [['lumina-3dgs', s]
                                              for s in RENDER_SHAPES]


@pytest.mark.parametrize('opt', OVERRIDES + ('no_such_field=1',))
def test_opt_overrides_match_jax(jax_dryrun, opt):
    want = jax_dryrun['overrides'][opt]
    if isinstance(want, str):
        with pytest.raises(ValueError, match='unknown override'):
            tdry._opt_overrides(tget('smollm-360m'), opt)
        assert want.startswith('ValueError: unknown override')
        return
    got = dataclasses.asdict(tdry._opt_overrides(tget('smollm-360m'), opt))
    assert json.loads(json.dumps(got)) == want


def test_fake_backend_missing_raises(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        'torch.testing._internal.distributed.fake_pg', None)
    with pytest.raises(RuntimeError, match="'fake' backend"):
        tdry.init_fake_world(256)


def test_dryrun_cli_smollm_two_layers():
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    cmd = [sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
           'smollm-360m', '--shape', 'train_4k', '--mesh', 'single', '--opt',
           'n_layers=2']
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    path = tdry.OUT_DIR / (tdry.stem_of('smollm-360m', 'train_4k', 'single',
                                        'n_layers=2') + '.json')
    rec = json.loads(path.read_text())
    assert set(rec) == (JAX_RECORD_KEYS - {'lower_s', 'compile_s',
                                           'hlo_chars'}) | {'count_s',
                                                            'n_ops'}
    assert set(rec['memory_analysis']) == MEMORY_KEYS
    jrow = jrl.Roofline('a', 's', 'm', 1, 1.0, 1.0, 1.0, 0.0, {}).finalize()
    assert set(rec['roofline']) == set(jrow.row())
    assert (rec['chips'], rec['mesh'], rec['opt']) == (256, 'single',
                                                       'n_layers=2')

    cfg = dataclasses.replace(tget('smollm-360m'), n_layers=2)
    params = list(treg.abstract_params(cfg, TP).parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    moment_bytes = 2 * sum(p.numel() * 4 for p in params)   # float32 mu, nu
    step_bytes = 4                                          # int32 step
    sh = TSHAPES['train_4k']
    # tokens and labels, batch over data (16) and sequence over model (16):
    # the cell runs the partitioned program, recipe dp replicates the rest
    batch_bytes = 2 * sh.global_batch * sh.seq_len * 4 // rec['chips']
    mem = rec['memory_analysis']
    assert mem['argument_size_in_bytes'] == (param_bytes + moment_bytes
                                             + step_bytes + batch_bytes)
    assert mem['temp_size_in_bytes'] > 0
    assert mem['alias_size_in_bytes'] == 0
    assert mem['generated_code_size_in_bytes'] == 0
    row = rec['roofline']
    # the partitioned program: each rank computes its block, so the useful
    # share reads near 1 (1.10 as run: 6ND counts the input embedding as a
    # matmul, the step gathers it; the replicated program read 1 / chips)
    assert 0.5 < row['useful_ratio'] < 1.3
    assert row['note'] == 'n_layers=2; partitioned'
    assert sum(row['collective_counts'].values()) > 0
    assert rec['cost_analysis']['flops'] > 0 and rec['n_ops'] > 0

    table = subprocess.run([sys.executable, '-m', 'repro_torch.launch.dryrun',
                            '--table'], capture_output=True, text=True,
                           env=env, timeout=120, cwd=ROOT, check=True)
    assert any(line.startswith('smollm-360m') and 'train_4k' in line
               for line in table.stdout.splitlines())


# ---------------------------------------------------------------------------
# The render walk on meta
# ---------------------------------------------------------------------------

def render_inputs(device: str, capacity: int):
    """(scene, camera, config) of the small render cell on ``device``:
    the seeded structured scene on the CPU, its shapes on ``meta``."""
    scene = (trd.abstract_scene(SCENE) if device == 'meta'
             else structured_scene(0, SCENE, device=device))
    cam = orbit_trajectory(1, width=WIDTH, height_px=HEIGHT,
                           device=device)[0]
    c = tget('lumina-3dgs')
    return scene, cam, LuminaConfig(capacity=capacity, window=c.window,
                                    margin=c.margin, k_record=c.k_record,
                                    sort_method='sorted')


def stage_counts(device: str, capacity: int, monkeypatch) -> dict:
    """Each stage of the frame counted alone, and the walk's trips."""
    scene, cam, cfg = render_inputs(device, capacity)
    held, steps = {}, []

    def stage(name, fn):
        def run():
            held[name] = fn()
        return op_count.analyze(run)

    step = trast._walk_step

    def counted_step(*a, **kw):
        steps.append(1)
        return step(*a, **kw)

    out = {'project': stage('project', lambda: project(scene, cam))}
    out['sort'] = stage('sort', lambda: sort_scene(
        held['project'], WIDTH, HEIGHT, capacity, method='sorted',
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian))
    out['gather'] = stage('gather', lambda: gather_tile_features(
        held['project'], held['sort']))
    with monkeypatch.context() as m:
        m.setattr(trast, '_walk_step', counted_step)
        out['walk'] = stage('walk', lambda: trast.rasterize_tiles(
            held['gather'], held['sort'].tiles_x, k_record=cfg.k_record,
            bg=cfg.bg, chunk=CHUNK))
    return out, len(steps) // CHUNK


@pytest.mark.parametrize('capacity', [128, 256])
def test_render_walk_on_meta_takes_every_chunk(capacity, monkeypatch):
    meta, meta_trips = stage_counts('meta', capacity, monkeypatch)
    cpu, cpu_trips = stage_counts('cpu', capacity, monkeypatch)
    assert meta_trips == capacity // CHUNK
    assert 0 < cpu_trips <= meta_trips
    for key in ('flops', 'bytes', 'n_ops', 'peak_bytes'):
        assert meta['walk'][key] >= cpu['walk'][key] > 0, key
    for stage in ('project', 'sort', 'gather'):
        assert meta[stage] == cpu[stage], stage
