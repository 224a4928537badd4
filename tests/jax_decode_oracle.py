"""The JAX package's partitioned decode step on 4 forced host devices, saved
for the port's partitioned decode tests (``tests/test_torch_mesh_decode.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_decode_oracle.py OUT.npz ARCH...

The test process holds JAX with one CPU device, so this runs in a process
of its own (``run``).  For each reduced arch of ``ARCHS`` on
``make_test_mesh`` (data 2, model 2), as the JAX package's dry run builds
its decode cells (``src/repro/launch/dryrun.py``): the decode step jitted
with ``in_shardings`` (parameters by ``param_specs``, the token by
``batch_shardings``, the zeroed K/V caches [L, B, T, Hkv, hd] by
``decode_state_specs``, ``pos`` replicated) and ``out_shardings``
(logits replicated, the caches as they came), one step at each position
of ``POSITIONS`` on seeded numpy tokens; beside it the same steps jitted
with no shardings (``plain_...``: the program whose write at a start past
the end clamps to the last position).  Saved under ``ARCH/...``: the
starting weights (``p0``), the tokens, each step's logits, the caches
after the last step gathered, and the caches' shard shape.
"""
import os
import subprocess
import sys

import numpy as np

FLAGS = '--xla_force_host_platform_device_count=4'
HERE = os.path.dirname(os.path.abspath(__file__))

# smollm: recipe dp; yi: recipe tp.  Both reduced: 2 layers, 2 kv heads,
# head_dim 32, float32
ARCHS = ('smollm-360m', 'yi-34b')
BATCH, MAX_SEQ = 4, 16
# positions 0..11 write into both blocks of the sequence (8 each on
# 'model') and attend across the boundary; 20 clamps the write to 15
POSITIONS = tuple(range(12)) + (20,)


def run(out_path, *archs) -> None:
    """Run the archs in a fresh process with 4 host devices, saving their
    arrays at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = src + os.pathsep + env.get('PYTHONPATH', '')
    subprocess.run([sys.executable, os.path.abspath(__file__), str(out_path),
                    *archs], env=env, check=True, timeout=300)


def tokens(vocab: int, seed: int) -> np.ndarray:
    """One [BATCH, 1] int32 token a step of ``POSITIONS``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (len(POSITIONS), BATCH, 1), dtype=np.int32)


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as ``prefix/a/b`` keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f'{prefix}/{k}'))
        else:
            out[f'{prefix}/{k}'] = np.asarray(v)
    return out


def case(arch: str, out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import registry
    from repro.runtime.sharding import spec_to_sharding

    mesh = make_test_mesh((2, 2))
    cfg = get_config(arch).reduced()
    ctx = registry.make_ctx(mesh, cfg)
    tp = registry.tp_of(mesh, cfg)
    p0 = jax.tree.map(np.asarray, registry.init_params(
        jax.random.PRNGKey(0), cfg, tp))
    toks = tokens(cfg.vocab, 1)

    p_sh = spec_to_sharding(mesh, registry.param_specs(cfg, p0, mesh))
    state = registry.init_decode_state(cfg, BATCH, MAX_SEQ, tp)
    s_sh = spec_to_sharding(mesh, registry.decode_state_specs(
        cfg, state, mesh, long_context=False))
    tok_sh = spec_to_sharding(mesh, registry.batch_shardings(cfg, mesh,
                                                             toks[0]))
    repl = NamedSharding(mesh, P())
    steps = {'': jax.jit(registry.make_decode_step(cfg, ctx),
                         in_shardings=(p_sh, tok_sh, s_sh, repl),
                         out_shardings=(repl, s_sh)),
             'plain_': jax.jit(registry.make_decode_step(
                 cfg, registry.make_ctx(None, cfg)))}
    for name, step in steps.items():
        st, logits = state, []
        for tok, pos in zip(toks, POSITIONS):
            lg, st = step(p0, tok, st, jnp.int32(pos))
            logits.append(np.asarray(lg))
        out[f'{arch}/{name}logits'] = np.stack(logits)
        out[f'{arch}/{name}k'], out[f'{arch}/{name}v'] = (np.asarray(c)
                                                          for c in st)
    out[f'{arch}/tokens'] = toks
    out[f'{arch}/shard'] = np.asarray(s_sh[0].shard_shape(state[0].shape))
    out.update(flat(p0, f'{arch}/p0'))


def main(argv) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f'need 4 host devices ({FLAGS}), have '
                         f'{len(jax.devices())}')
    out_path, archs = argv[0], argv[1:]
    out: dict = {}
    for arch in archs:
        case(arch, out)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == '__main__':
    main(sys.argv[1:])
