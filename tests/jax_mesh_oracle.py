"""The JAX package's mesh paths on 4 forced host devices, saved for the
port's mesh parity tests (``tests/test_torch_mesh_*.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_mesh_oracle.py OUT.npz CASE...

The test process holds JAX with one CPU device, so this runs in a process
of its own (``run``).  Each case makes its inputs from a seed with numpy
or the JAX package's own generators, runs the JAX path on
``make_test_mesh`` and writes inputs and outputs under ``CASE/...`` keys:

  * ``moe``: reduced granite's expert-parallel ``moe_ffn`` on (data 2,
    model 2), on a fixture whose router sends one row's tokens to expert 0
    first (per-rank capacity drops tokens where the local path drops
    none) and on one without the bias (output and gradients);
  * ``psum``: ``psum_compressed`` over a 4-way ``data`` axis;
  * ``gpipe``: ``gpipe_forward`` on (pod 2, data 2) and the unpipelined
    stack;
  * ``frame``: ``render_dist._serve_frame`` at 64 px on (data 2, model 2);
  * ``train``: ``launch.train.train`` of reduced granite-moe and smollm on
    (data 2, model 2), with the weights it starts from, and granite's
    token server on the same mesh.
"""
import os
import subprocess
import sys

import numpy as np

FLAGS = '--xla_force_host_platform_device_count=4'
HERE = os.path.dirname(os.path.abspath(__file__))

MOE_ARCH, MOE_B, MOE_S = 'granite-moe-1b-a400m', 4, 1024
MOE_GRAD_B, MOE_GRAD_S = 2, 64
PSUM_SHAPES = {'a': (300,), 'b': (16, 33), 'c': (2, 3, 129)}
GPIPE_L, GPIPE_B, GPIPE_S, GPIPE_D, GPIPE_MICRO = 4, 8, 4, 16, 4
FRAME_N, FRAME_PX, FRAME_CAP = 1000, 64, 128
TRAIN_ARCHS = ('granite-moe-1b-a400m', 'smollm-360m')
TRAIN = dict(steps=3, batch=4, seq=64, lr=3e-3, warmup=1)
SERVE = dict(slots=2, max_seq=32)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 3, 4, 4


def run(out_path, *cases) -> None:
    """Run the cases in a fresh process with 4 host devices, saving their
    arrays at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = src + os.pathsep + env.get('PYTHONPATH', '')
    subprocess.run([sys.executable, os.path.abspath(__file__), str(out_path),
                    *cases], env=env, check=True, timeout=300)


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as ``prefix/a/b`` keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f'{prefix}/{k}'))
        else:
            out[f'{prefix}/{k}'] = np.asarray(v)
    return out


def moe_inputs(jmoe, cfg, b: int, s: int, bias: bool, seed: int) -> tuple:
    import jax
    import jax.numpy as jnp
    p = jax.tree.map(np.array, jmoe.moe_params(jax.random.PRNGKey(seed),
                                                 cfg, jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if bias:
        # feature 0 is 1 on row 0's tokens (0 elsewhere) and expert 0's
        # logit weighs it by 10: row 0 sends every token to expert 0 first,
        # more than the per-rank capacity of the ranks that hold row 0
        # takes, less than the capacity of the whole batch
        x[..., 0] = 0.0
        x[0, :, 0] = 1.0
        p['router'][0, 0] = 10.0
    return p, x


def case_moe(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as jmoe
    from repro.runtime.sharding import ShardCtx
    cfg = get_config(MOE_ARCH).reduced()
    ep, local = ShardCtx(mesh=make_test_mesh((2, 2))), ShardCtx(mesh=None)
    p, x = moe_inputs(jmoe, cfg, MOE_B, MOE_S, True, 0)
    for name, ctx in (('ep', ep), ('local', local)):
        o, drop = jax.jit(lambda p, x, c=ctx: jmoe.moe_ffn(p, x, cfg, c))(p, x)
        out[f'moe/{name}/out'], out[f'moe/{name}/drop'] = o, drop
    out.update(flat(p, 'moe/p'))
    out['moe/x'] = x

    p, x = moe_inputs(jmoe, cfg, MOE_GRAD_B, MOE_GRAD_S, False, 1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    for name, ctx in (('ep', ep), ('local', local)):
        def loss(p, x, c=ctx):
            o, _ = jmoe.moe_ffn(p, x, cfg, c)
            return jnp.sum(o * r)
        (o, drop) = jax.jit(lambda p, x, c=ctx: jmoe.moe_ffn(p, x, cfg, c))(
            p, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        out[f'moe_grad/{name}/out'], out[f'moe_grad/{name}/drop'] = o, drop
        out.update(flat(gp, f'moe_grad/{name}/gp'))
        out[f'moe_grad/{name}/gx'] = gx
    out.update(flat(p, 'moe_grad/p'))
    out['moe_grad/x'], out['moe_grad/r'] = x, r


def case_psum(out: dict) -> None:
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_test_mesh
    from repro.optim.compression import psum_compressed
    mesh = make_test_mesh((4,), ('data',))
    rng = np.random.default_rng(3)
    # each rank's gradients at a scale of its own (1e-3 .. 10), so the
    # block scales differ across ranks and the requantization moves them
    grads = {k: (rng.standard_normal((4,) + s) * 10.0 ** rng.integers(
        -3, 2, (4,) + (1,) * len(s))).astype(np.float32)
        for k, s in PSUM_SHAPES.items()}
    res = {k: (1e-3 * rng.standard_normal((4,) + s)).astype(np.float32)
           for k, s in PSUM_SHAPES.items()}

    def body(g, r):
        g = jax.tree.map(lambda a: a[0], g)
        r = jax.tree.map(lambda a: a[0], r)
        red, new = psum_compressed(g, r, 'data')
        return (jax.tree.map(lambda a: a[None], red),
                jax.tree.map(lambda a: a[None], new))

    # eager, as the port runs: under jit XLA may fuse the residual's
    # multiply-subtract into one rounding
    f = jax.shard_map(body, mesh=mesh, in_specs=(P('data'), P('data')),
                      out_specs=(P('data'), P('data')), check_vma=False)
    red, new = f(grads, res)
    out.update(flat(grads, 'psum/g'))
    out.update(flat(res, 'psum/r'))
    out.update(flat(red, 'psum/sum'))
    out.update(flat(new, 'psum/res'))


def gpipe_block(p, x):
    """The GPipe fixture's layer stack: x + tanh(x @ w) per layer."""
    import jax.numpy as jnp
    for i in range(p['w'].shape[0]):
        x = x + jnp.tanh(x @ p['w'][i])
    return x


def case_gpipe(out: dict) -> None:
    import jax
    from repro.launch.mesh import make_test_mesh
    from repro.runtime.pipeline import gpipe_forward, split_stage_params
    mesh = make_test_mesh((2, 2), ('pod', 'data'))
    rng = np.random.default_rng(4)
    w = (0.3 * rng.standard_normal((GPIPE_L, GPIPE_D, GPIPE_D))).astype(
        np.float32)
    x = rng.standard_normal((GPIPE_B, GPIPE_S, GPIPE_D)).astype(np.float32)
    sp = split_stage_params({'w': w}, 2)
    y = jax.jit(lambda sp, x: gpipe_forward(
        gpipe_block, sp, x, mesh=mesh, n_microbatches=GPIPE_MICRO))(sp, x)
    out['gpipe/w'], out['gpipe/x'] = w, x
    out['gpipe/y'] = y
    out['gpipe/ref'] = jax.jit(gpipe_block)({'w': w}, x)


def case_frame(out: dict) -> None:
    import jax
    from repro.core.pipeline import LuminaConfig
    from repro.core.render_dist import _serve_frame
    from repro.data.scenes import structured_scene
    from repro.data.trajectory import orbit_trajectory
    from repro.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2))
    scene = structured_scene(jax.random.PRNGKey(5), FRAME_N)
    cam = orbit_trajectory(1, width=FRAME_PX, height_px=FRAME_PX)[0]
    cfg = LuminaConfig(capacity=FRAME_CAP, sort_method='sorted')
    colors, nsig = jax.jit(lambda s: _serve_frame(s, cam, mesh, cfg))(scene)
    for f in ('means', 'log_scales', 'quats', 'opacity_logit', 'sh_dc',
              'sh_rest'):
        out[f'frame/scene/{f}'] = np.asarray(getattr(scene, f))
    for f in ('position', 'quat', 'fx', 'fy', 'cx', 'cy'):
        out[f'frame/cam/{f}'] = np.asarray(getattr(cam, f))
    out['frame/colors'], out['frame/nsig'] = colors, nsig


def case_train(out: dict) -> None:
    import jax
    from repro.configs import get_config
    from repro.data.tokens import synthetic_tokens
    from repro.launch import serve
    from repro.launch.mesh import make_test_mesh
    from repro.launch.train import train
    from repro.models import registry
    mesh = make_test_mesh((2, 2))
    # the server on the mesh (its weights: seed 0 at tp 2, as train's)
    server = serve.Server(TRAIN_ARCHS[0], mesh=mesh, **SERVE)
    pending = [serve.Request(rid=i, prompt=synthetic_tokens(
        7, i, 1, SERVE_PROMPT, server.cfg.vocab)[0], max_new=SERVE_NEW)
        for i in range(SERVE_REQUESTS)]
    done = []
    while pending or any(server.slot_req):
        for slot in server.free_slots():
            if pending:
                server.admit(pending.pop(0), slot)
        done.extend(server.step())
    for r in done:
        out[f'serve/{r.rid}'] = np.asarray(r.out, np.int32)
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        tp = registry.tp_of(mesh, cfg)
        p0 = jax.tree.map(np.asarray, registry.init_params(
            jax.random.PRNGKey(0), cfg, tp))
        _, _, hist = train(arch, mesh=mesh, log_every=0,
                           print_fn=lambda *a: None, **TRAIN)
        out.update(flat(p0, f'train/{arch}/p0'))
        out[f'train/{arch}/loss'] = np.asarray(hist, np.float64)


def main(argv) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f'need 4 host devices ({FLAGS}), have '
                         f'{len(jax.devices())}')
    out_path, cases = argv[0], argv[1:]
    out: dict = {}
    for case in cases:
        globals()[f'case_{case}'](out)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == '__main__':
    sys.path.insert(0, HERE)
    main(sys.argv[1:])
