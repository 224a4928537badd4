"""The port's side of the mesh parity tests (``tests/test_torch_mesh_*.py``):
a 4-rank gloo group on the CPU, and the function each rank runs.

``spawn`` starts the ranks with the ``spawn`` method, so each one begins
from a fresh import of this module, which imports only numpy, torch and
``repro_torch`` (and the oracle's constants, numpy only): the children
never import JAX.  Each rank joins the group through a ``FileStore`` under
the test's ``tmp_path``, runs on one torch thread, and saves what its
function returns with ``torch.save``; ``spawn`` returns every rank's.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from jax_mesh_oracle import (FRAME_CAP, FRAME_PX, GPIPE_MICRO, MOE_ARCH,
                             SERVE, SERVE_NEW, SERVE_PROMPT, SERVE_REQUESTS,
                             TRAIN, TRAIN_ARCHS)

WORLD = 4
TIMEOUT_S = 180


def _entry(fn, rank: int, world: int, outdir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', store=dist.FileStore(os.path.join(outdir, 'store'), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(outdir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn(fn, tmp_path, *args, world: int = WORLD) -> list:
    """Run ``fn(rank, *args)`` on every rank of a ``world``-rank gloo
    group; returns each rank's result.  Raises if a rank fails or the run
    outlasts ``TIMEOUT_S``."""
    outdir = tempfile.mkdtemp(prefix=f'{fn.__name__}_', dir=tmp_path)
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_entry, args=(fn, r, world, outdir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    if alive:
        raise TimeoutError(f'{fn.__name__}: {len(alive)} ranks still ran '
                           f'after {TIMEOUT_S} s')
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f'{fn.__name__}: rank exit codes {codes}')
    return [torch.load(os.path.join(outdir, f'rank{r}.pt'))
            for r in range(world)]


def load(npz_path: str) -> dict:
    with np.load(npz_path) as z:
        return dict(z)


def tensors(arrays: dict, prefix: str, leaf=None) -> dict:
    """The ``prefix/...`` arrays as a nested dict of tensors (or of
    ``leaf(array)``)."""
    out: dict = {}
    for key, val in arrays.items():
        if not key.startswith(prefix + '/'):
            continue
        *path, name = key[len(prefix) + 1:].split('/')
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[name] = (torch.from_numpy(np.array(val)) if leaf is None
                      else leaf(val))
    return out


# --- the rank functions ------------------------------------------------------

def moe_rank(rank: int, npz_path: str) -> dict:
    """Expert-parallel ``moe_ffn`` on (data 2, model 2): the dropping
    fixture's output and drop, the same through the local path, and the
    gradient fixture's output and gradients."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe, registry
    arrays = load(npz_path)
    cfg = get_config(MOE_ARCH).reduced()
    mesh = make_test_mesh((2, 2), device='cpu')
    ctx = registry.make_ctx(mesh, cfg)
    out = {}
    p, x = tensors(arrays, 'moe/p'), torch.from_numpy(arrays['moe/x'])
    out['ep'] = moe.moe_ffn(p, x, cfg, ctx)
    out['local'] = moe.moe_ffn(p, x, cfg)

    p = {k: v.requires_grad_()
         for k, v in tensors(arrays, 'moe_grad/p').items()}
    x = torch.from_numpy(arrays['moe_grad/x']).requires_grad_()
    o, drop = moe.moe_ffn(p, x, cfg, ctx)
    (o * torch.from_numpy(arrays['moe_grad/r'])).sum().backward()
    out['grad'] = {'out': o.detach(), 'drop': drop, 'gx': x.grad,
                   'gp': {k: v.grad for k, v in p.items()}}
    return out


def psum_rank(rank: int, npz_path: str) -> dict:
    """``psum_compressed`` of this rank's gradients over a 4-way ``data``
    axis."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compression import psum_compressed
    arrays = load(npz_path)
    mesh = make_test_mesh((4,), ('data',), device='cpu')
    grads = {k: v[rank] for k, v in tensors(arrays, 'psum/g').items()}
    res = {k: v[rank] for k, v in tensors(arrays, 'psum/r').items()}
    red, new = psum_compressed(grads, res, mesh.get_group('data'))
    return {'sum': red, 'res': new}


def gpipe_block(p, x):
    """The GPipe fixture's layer stack: x + tanh(x @ w) per layer."""
    for i in range(p['w'].shape[0]):
        x = x + torch.tanh(x @ p['w'][i])
    return x


def gpipe_rank(rank: int, npz_path: str) -> dict:
    """``gpipe_forward`` on (pod 2, data 2), and the unpipelined stack."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.pipeline import gpipe_forward, split_stage_params
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), ('pod', 'data'), device='cpu')
    w, x = (torch.from_numpy(arrays[f'gpipe/{k}']) for k in ('w', 'x'))
    sp = split_stage_params({'w': w}, 2)
    y = gpipe_forward(gpipe_block, sp, x, mesh=mesh,
                      n_microbatches=GPIPE_MICRO)
    return {'y': y, 'ref': gpipe_block({'w': w}, x)}


def frame_rank(rank: int, npz_path: str) -> dict:
    """``render_dist._serve_frame`` on (data 2, model 2) and without a
    mesh, on the oracle's scene and camera."""
    from repro_torch import interop
    from repro_torch.core import render_dist
    from repro_torch.core.pipeline import LuminaConfig
    from repro_torch.launch.mesh import make_test_mesh
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')
    scene = interop.scene_from_numpy(*(
        arrays[f'frame/scene/{f}'] for f in ('means', 'log_scales', 'quats',
                                             'opacity_logit', 'sh_dc',
                                             'sh_rest')), device='cpu')
    cam = interop.camera_from_numpy(*(
        arrays[f'frame/cam/{f}'] for f in ('position', 'quat', 'fx', 'fy',
                                           'cx', 'cy')),
        FRAME_PX, FRAME_PX, device='cpu')
    cfg = LuminaConfig(capacity=FRAME_CAP, sort_method='sorted')
    return {'mesh': render_dist._serve_frame(scene, cam, mesh, cfg),
            'alone': render_dist._serve_frame(scene, cam, None, cfg)}


def train_rank(rank: int, npz_path: str) -> dict:
    """``launch.train.train`` of each reduced arch of ``TRAIN_ARCHS`` on
    (data 2, model 2) and granite's token server on the same mesh, each
    starting from the oracle's weights of its arch."""
    from repro_torch import interop
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import registry
    arrays = load(npz_path)
    mesh = make_test_mesh((2, 2), device='cpu')

    def jax_weights(seed, cfg, tp=1, *, device=None):
        p0 = tensors(arrays, f'train/{cfg.name}/p0', np.asarray)
        return interop.lm_params_from_numpy(p0, cfg, device=device)

    registry.init_params = jax_weights
    out = {}
    for arch in TRAIN_ARCHS:
        model, _, hist = ttrain.train(arch, mesh=mesh, device='cpu',
                                      log_every=0, **TRAIN)
        out[arch] = {'loss': hist, 'params': {
            k: p.detach() for k, p in model.named_parameters()}}
    out['serve'] = serve_on_mesh(MOE_ARCH, mesh)
    return out


def serve_on_mesh(arch: str, mesh) -> dict:
    """The token server on ``mesh`` (the weights ``init_params`` gives):
    each request's tokens, and the expert-parallel calls it made."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    calls = []
    ep = moe._moe_ffn_ep

    def counted(*a):
        calls.append(a[1].shape)
        return ep(*a)

    moe._moe_ffn_ep = counted
    try:
        server = serve.Server(arch, mesh=mesh, device='cpu', **SERVE)
        done, _ = serve.drain(server, serve.synthetic_requests(
            SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, server.cfg.vocab,
            device='cpu'))
    finally:
        moe._moe_ffn_ep = ep
    return {'tokens': {r.rid: r.out for r in done}, 'ep_calls': len(calls),
            'tp': server.ctx.tp}


def elastic_rank(rank: int, ckpt_dir: str) -> dict:
    """Elastic recovery on the 4-rank world: rank 0 checkpoints a state;
    two ranks fail, ``plan_remesh`` keeps ``model=2`` on the 2 survivors,
    every rank builds the new mesh and restores, and the survivors place
    the restored state on it with ``reshard_tree``.  Before that, on the
    whole world: the serving mesh's placements, and ``ShardCtx.btd``
    redistributing a replicated DTensor on (data 2, model 2)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_serve_mesh, make_test_mesh
    from repro_torch.runtime.elastic import (build_mesh, plan_remesh,
                                             reshard_tree)
    from repro_torch.runtime.sharding import (P, ShardCtx,
                                              fleet_axis_sharding,
                                              replicated)
    serve = make_serve_mesh(device='cpu')
    mesh = make_test_mesh((2, 2), device='cpu')
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    y = ShardCtx(mesh=mesh).btd(distribute_tensor(x, mesh, replicated(mesh)))
    hooks = {'serve_axes': serve.mesh_dim_names,      # placements by name
             'fleet': [str(p) for p in fleet_axis_sharding(serve)],
             'btd': [str(p) for p in y.placements],
             'btd_local': y.to_local(), 'btd_full': y.full_tensor()}
    state = {'w': torch.arange(16.0).reshape(4, 4),
             'b': torch.arange(6.0), 'step': torch.tensor(5)}
    specs = {'w': P('data', 'model'), 'b': P('model'), 'step': P()}
    mgr = CheckpointManager(ckpt_dir)
    if rank == 0:
        mgr.save(state, step=5)
        mgr.wait()
    dist.barrier()
    plan = plan_remesh(4, 2, model=2)
    mesh = build_mesh(plan, device='cpu')
    tree, step, _ = mgr.restore_latest({k: torch.zeros_like(v)
                                        for k, v in state.items()})
    out = {'plan': (plan.shape, plan.devices_used, plan.grad_accum_factor),
           'step': step, 'in_mesh': rank < plan.devices_used, **hooks}
    if out['in_mesh']:
        placed = reshard_tree(tree, specs, mesh)
        out['full'] = {k: v.full_tensor() for k, v in placed.items()}
        out['local'] = {k: v.to_local() for k, v in placed.items()}
    return out
