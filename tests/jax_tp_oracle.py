"""The JAX package's partitioned LM program on 4 forced host devices, saved
for the port's partitioned parity tests (``tests/test_torch_mesh_tp.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_tp_oracle.py OUT.npz ARCH...

The test process holds JAX with one CPU device, so this runs in a process
of its own (``run``).  For each reduced arch of ``ARCHS`` on
``make_test_mesh`` (data 2, model 2), as the JAX package's dry run builds
its cells: parameters, Adam state and batch laid out by ``param_specs``,
``batch_shardings`` and the state's (moments as their parameters, the
step replicated); the train step (the train driver's, with its warmup
schedule) jitted with those ``in_shardings`` and ``out_shardings``,
``STEPS`` steps at ``LR`` with ``WARMUP`` warmup step on seeded numpy
batches; the prefill jitted with the parameters' and the batch's
shardings, on the starting weights.  Saved under ``ARCH/...``: the
starting weights (``p0``), the batches, the losses and gradient norms,
the logits, the trained parameters and moments gathered, and the shard
shape of every parameter (``shard/...``).
"""
import os
import subprocess
import sys

import numpy as np

FLAGS = '--xla_force_host_platform_device_count=4'
HERE = os.path.dirname(os.path.abspath(__file__))

# smollm: recipe dp; yi: recipe tp, with remat on (the port recomputes its
# DTensor blocks in the backward pass)
ARCHS = {'smollm-360m': {}, 'yi-34b': {'remat': True}}
STEPS, BATCH, SEQ, LR, WARMUP = 3, 4, 64, 3e-3, 1
PREFILL_BATCH, PREFILL_SEQ = 2, 32
IGNORE_FRAC = 0.1     # labels set to -1 (ignored by the loss)


def run(out_path, *archs) -> None:
    """Run the archs in a fresh process with 4 host devices, saving their
    arrays at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = src + os.pathsep + env.get('PYTHONPATH', '')
    subprocess.run([sys.executable, os.path.abspath(__file__), str(out_path),
                    *archs], env=env, check=True, timeout=300)


def batches(vocab: int, seed: int) -> list:
    """``STEPS`` train batches of ``BATCH`` x ``SEQ`` (next-token labels,
    a share of them -1) and one prefill batch, numpy int32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        labels = t[:, 1:].copy()
        labels[rng.random(labels.shape) < IGNORE_FRAC] = -1
        out.append({'tokens': t[:, :-1], 'labels': labels})
    out.append({'tokens': rng.integers(0, vocab, (PREFILL_BATCH, PREFILL_SEQ),
                                       dtype=np.int32)})
    return out


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
    from repro.optim import adam, schedule
    from repro.runtime.sharding import spec_to_sharding

    mesh = make_test_mesh((2, 2))
    cfg = get_config(arch).reduced(**ARCHS[arch])
    ctx = registry.make_ctx(mesh, cfg)
    tp = registry.tp_of(mesh, cfg)
    p0 = jax.tree.map(np.asarray, registry.init_params(
        jax.random.PRNGKey(0), cfg, tp))
    *train_batches, prefill_batch = batches(cfg.vocab, 1)

    p_sh = spec_to_sharding(mesh, registry.param_specs(cfg, p0, mesh))
    b_sh = spec_to_sharding(mesh, registry.batch_shardings(
        cfg, mesh, train_batches[0]))
    repl = NamedSharding(mesh, P())
    o_sh = adam.AdamState(step=repl, mu=p_sh, nu=p_sh)
    acfg = adam.AdamConfig(lr=LR, state_dtype=jnp.dtype(cfg.opt_state_dtype))
    mod = registry.module_for(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: mod.train_loss(p, batch, cfg, ctx))(params)
        params, opt_state, gnorm = adam.step(
            params, grads, opt_state, acfg,
            lr_scale=schedule.linear_warmup_cosine(
                opt_state.step, warmup_steps=WARMUP, total_steps=STEPS))
        return params, opt_state, {'loss': loss, 'grad_norm': gnorm}

    step = jax.jit(train_step, in_shardings=(p_sh, o_sh, b_sh),
                   out_shardings=(p_sh, o_sh, {'loss': repl,
                                               'grad_norm': repl}))
    pf_sh = spec_to_sharding(mesh, registry.batch_shardings(
        cfg, mesh, prefill_batch))
    prefill = jax.jit(registry.make_prefill(cfg, ctx),
                      in_shardings=(p_sh, pf_sh), out_shardings=repl)
    out[f'{arch}/logits'] = np.asarray(prefill(p0, prefill_batch))

    params, opt_state = p0, adam.init(p0, acfg)
    losses, norms = [], []
    for b in train_batches:
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    out[f'{arch}/loss'] = np.asarray(losses, np.float64)
    out[f'{arch}/grad_norm'] = np.asarray(norms, np.float64)
    out.update(flat(p0, f'{arch}/p0'))
    out.update(flat(jax.tree.map(np.asarray, params), f'{arch}/params'))
    out.update(flat(jax.tree.map(np.asarray, opt_state.mu), f'{arch}/mu'))
    out.update(flat(jax.tree.map(np.asarray, opt_state.nu), f'{arch}/nu'))
    shard = jax.tree.map(lambda a, s: np.asarray(s.shard_shape(a.shape)),
                         p0, p_sh)
    out.update(flat(shard, f'{arch}/shard'))
    for i, b in enumerate(train_batches + [prefill_batch]):
        out.update(flat(b, f'{arch}/batch{i}'))


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
