"""The JAX package's partitioned recurrent programs (recipe ``ssm``) on 4
forced host devices, saved for the port's parity tests
(``tests/test_torch_mesh_ssm.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_ssm_oracle.py OUT.npz ARCH[:PART]...

The test process holds JAX with one CPU device, so this runs in processes
of its own (``run``: one an arch and part of ``PARTS``, side by side).  For
each reduced arch of ``ARCHS`` on ``make_test_mesh`` (data 2, model 2), as
the JAX package's dry run builds its cells, everything jitted with
``in_shardings`` and ``out_shardings`` from ``param_specs``,
``batch_shardings`` and ``decode_state_specs``:

  * the train step (the train driver's, with its warmup schedule),
    ``STEPS`` steps at ``LR`` with ``WARMUP`` warmup step on seeded numpy
    batches, the Adam state laid out as its parameters;
  * the prefill on the starting weights, and unpartitioned beside it;
  * the decode step at each of ``POSITIONS`` on a zeroed state (zamba2's
    caches of ``MAX_SEQ`` positions) and seeded tokens.

Saved under ``ARCH/...``: the starting weights (``p0``), the batches and
tokens, the losses and gradient norms, the prefill logits (and the same
prefill unpartitioned, ``plain_logits``), the trained
parameters and moments gathered, the shard shape of every parameter
(``shard/...``), each decode step's logits, the decode state gathered
(``state/...``) and the shard shape of each of its leaves
(``state_shard/...``).
"""
import os
import subprocess
import sys

import numpy as np

FLAGS = '--xla_force_host_platform_device_count=4'
HERE = os.path.dirname(os.path.abspath(__file__))

# xlstm: 3 heads, which 'model' (2) does not divide, so the mLSTM state
# takes the production layout (dk over 'model'; xlstm-1.3b's 4 heads on 16
# ranks), hd 64; two super-blocks of an mLSTM and an sLSTM block, remat on
# (its published setting).  zamba2: two attention points; its w_in split
# (560 columns, 280 a rank) and conv channels (288, 144 a rank) straddle
# the parts, as at production size
ARCHS = {'xlstm-1.3b': {'n_layers': 4, 'd_model': 96, 'n_heads': 3,
                        'remat': True},
         'zamba2-1.2b': {'n_layers': 4}}
STEPS, BATCH, SEQ, LR, WARMUP = 3, 4, 64, 3e-3, 1
PREFILL_BATCH, PREFILL_SEQ = 2, 32
IGNORE_FRAC = 0.1     # labels set to -1 (ignored by the loss)
DECODE_BATCH, MAX_SEQ = 4, 16
POSITIONS = tuple(range(12))    # both blocks of zamba2's caches (8 each)
# the train steps; the prefill and decode
PARTS = ('train', 'serve')


def run(out_path, *archs) -> None:
    """Run each part of each arch in a fresh process with 4 host devices,
    all side by side, and save their arrays together at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = src + os.pathsep + env.get('PYTHONPATH', '')
    jobs = [f'{arch}:{part}' for arch in archs for part in PARTS]
    parts = [f'{out_path}.{i}.npz' for i in range(len(jobs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               part, job], env=env)
             for part, job in zip(parts, jobs)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f'jax_ssm_oracle: exit codes {codes}')
    out: dict = {}
    for part in parts:
        with np.load(part) as z:
            out.update(z)
        os.remove(part)
    np.savez(out_path, **out)


def batches(vocab: int, seed: int) -> dict:
    """``STEPS`` train batches of ``BATCH`` x ``SEQ`` (next-token labels,
    a share of them -1), one prefill batch and the decode tokens (one
    [DECODE_BATCH, 1] a step), numpy int32."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(STEPS):
        t = rng.integers(0, vocab, (BATCH, SEQ + 1), dtype=np.int32)
        labels = t[:, 1:].copy()
        labels[rng.random(labels.shape) < IGNORE_FRAC] = -1
        out[f'batch{i}'] = {'tokens': t[:, :-1], 'labels': labels}
    out['prefill'] = {'tokens': rng.integers(
        0, vocab, (PREFILL_BATCH, PREFILL_SEQ), dtype=np.int32)}
    out['decode'] = rng.integers(0, vocab, (len(POSITIONS), DECODE_BATCH, 1),
                                 dtype=np.int32)
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


def _train(arch: str, out: dict, cfg, ctx, p0, data: dict, p_sh, b_sh,
           repl) -> None:
    """The train step jitted with the layouts, ``STEPS`` steps from ``p0``,
    the Adam state laid out as its parameters."""
    import jax
    import jax.numpy as jnp
    from repro.models import registry
    from repro.optim import adam, schedule
    train_batches = [data[f'batch{i}'] for i in range(STEPS)]
    o_sh = adam.AdamState(step=repl, mu=p_sh, nu=p_sh)
    acfg = adam.AdamConfig(lr=LR, state_dtype=jnp.dtype(cfg.opt_state_dtype))
    loss_fn = registry.module_for(cfg).train_loss

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, batch, cfg, ctx))(params)
        params, opt_state, gnorm = adam.step(
            params, grads, opt_state, acfg,
            lr_scale=schedule.linear_warmup_cosine(
                opt_state.step, warmup_steps=WARMUP, total_steps=STEPS))
        return params, opt_state, {'loss': loss, 'grad_norm': gnorm}

    step = jax.jit(train_step,
                   in_shardings=(p_sh, o_sh, b_sh(train_batches[0])),
                   out_shardings=(p_sh, o_sh, {'loss': repl,
                                               'grad_norm': repl}))
    params, opt_state, losses, norms = p0, adam.init(p0, acfg), [], []
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
    for i, b in enumerate(train_batches):
        out.update(flat(b, f'{arch}/batch{i}'))


def _serve(arch: str, out: dict, cfg, ctx, p0, data: dict, p_sh, b_sh,
           repl) -> None:
    """The prefill and the decode steps from a zeroed state, each jitted
    with the layouts."""
    import jax
    import jax.numpy as jnp
    from repro.models import registry
    from repro.runtime.sharding import spec_to_sharding
    mesh = ctx.mesh
    prefill = jax.jit(registry.make_prefill(cfg, ctx),
                      in_shardings=(p_sh, b_sh(data['prefill'])),
                      out_shardings=repl)
    out[f'{arch}/logits'] = np.asarray(prefill(p0, data['prefill']))
    out[f'{arch}/prefill_tokens'] = data['prefill']['tokens']
    # the same prefill unpartitioned: the reference's own partitioning noise
    out[f'{arch}/plain_logits'] = np.asarray(jax.jit(registry.make_prefill(
        cfg, registry.make_ctx(None, cfg)))(p0, data['prefill']))

    state = registry.init_decode_state(cfg, DECODE_BATCH, MAX_SEQ,
                                       registry.tp_of(mesh, cfg))
    s_sh = spec_to_sharding(mesh, registry.decode_state_specs(
        cfg, state, mesh, long_context=False))
    dstep = jax.jit(registry.make_decode_step(cfg, ctx),
                    in_shardings=(p_sh, b_sh(data['decode'][0]), s_sh, repl),
                    out_shardings=(repl, s_sh))
    logits = []
    for tok, pos in zip(data['decode'], POSITIONS):
        lg, state = dstep(p0, tok, state, jnp.int32(pos))
        logits.append(np.asarray(lg))
    out[f'{arch}/decode_logits'] = np.stack(logits)
    out[f'{arch}/decode_tokens'] = data['decode']
    out.update(flat(jax.tree.map(np.asarray, state), f'{arch}/state'))
    out.update(flat(jax.tree.map(
        lambda a, s: np.asarray(s.shard_shape(a.shape)), state, s_sh),
        f'{arch}/state_shard'))


def case(arch: str, part: str, out: dict) -> None:
    """``part`` of ``PARTS`` of reduced ``arch`` on (data 2, model 2), from
    the same weights and batches in every part, saved into ``out``."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import registry
    from repro.runtime.sharding import spec_to_sharding

    mesh = make_test_mesh((2, 2))
    cfg = get_config(arch).reduced(**ARCHS[arch])
    ctx = registry.make_ctx(mesh, cfg)
    p0 = jax.tree.map(np.asarray, registry.init_params(
        jax.random.PRNGKey(0), cfg, registry.tp_of(mesh, cfg)))
    p_sh = spec_to_sharding(mesh, registry.param_specs(cfg, p0, mesh))

    def b_sh(tree):
        return spec_to_sharding(mesh, registry.batch_shardings(cfg, mesh,
                                                               tree))

    run_part = {'train': _train, 'serve': _serve}[part]
    run_part(arch, out, cfg, ctx, p0, batches(cfg.vocab, 1), p_sh, b_sh,
             NamedSharding(mesh, P()))


def main(argv) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f'need 4 host devices ({FLAGS}), have '
                         f'{len(jax.devices())}')
    out_path, jobs = argv[0], argv[1:]
    out: dict = {}
    for job in jobs:
        arch, _, part = job.partition(':')
        for p in ([part] if part else PARTS):
            case(arch, p, out)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == '__main__':
    main(sys.argv[1:])
