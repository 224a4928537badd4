"""The JAX package's partitioned MoE program (recipe ``ep``) on 4 forced host
devices, saved for the port's parity tests (``tests/test_torch_mesh_ep.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_ep_oracle.py OUT.npz ARCH[:PART]...

The test process holds JAX with one CPU device, so this runs in processes
of its own (``run``: one an arch and part of ``PARTS``, side by side).  For each reduced arch of ``ARCHS`` on
``make_test_mesh`` (data 2, model 2), as the JAX package's dry run builds
its cells, everything jitted with ``in_shardings`` and ``out_shardings``
from ``param_specs``, ``batch_shardings`` and ``decode_state_specs``:

  * the train step (the train driver's, with its warmup schedule),
    ``STEPS`` steps at ``LR`` with ``WARMUP`` warmup step on seeded numpy
    batches, the Adam state laid out as its parameters;
  * the prefill on the starting weights;
  * the decode step at each of ``POSITIONS`` on zeroed caches of
    ``MAX_SEQ`` positions and seeded tokens;
  * one forward on ``SKEW_BATCH`` x ``SKEW_SEQ`` tokens whose router is
    skewed (``skew``): the tokens of rows 0 and 1 send their first
    assignment to expert 0, more than the per-rank capacity of the ranks
    that hold those rows takes, so the expert-parallel body drops tokens
    there and nowhere else.

Saved under ``ARCH/...``: the starting weights (``p0``) and the skewed
weights (``skew_p``), the batches and tokens, the losses and gradient
norms, the prefill logits, the trained parameters and moments gathered,
the shard shape of every parameter (``shard/...``), each decode step's
logits, the caches gathered and their shard shape, the skewed forward's
mean drop fraction.
"""
import os
import subprocess
import sys

import numpy as np

FLAGS = '--xla_force_host_platform_device_count=4'
HERE = os.path.dirname(os.path.abspath(__file__))

# granite: top-8 of 32 reduced to top-2 of 4, remat on (its published
# setting); maverick: top-1, a dense layer before each MoE layer, the
# shared expert, bfloat16 Adam moments, two super-blocks
ARCHS = {'granite-moe-1b-a400m': {'remat': True},
         'llama4-maverick-400b-a17b': {'n_layers': 4}}
STEPS, BATCH, SEQ, LR, WARMUP = 3, 4, 64, 3e-3, 1
PREFILL_BATCH, PREFILL_SEQ = 2, 32
IGNORE_FRAC = 0.1     # labels set to -1 (ignored by the loss)
DECODE_BATCH, MAX_SEQ = 4, 16
POSITIONS = tuple(range(12))    # both blocks of the sequence (8 each)
# each rank holds 2 rows x 256 positions: on data rank 0 all 512 want
# expert 0, past its per-rank capacity (granite 384, maverick 256); on data
# rank 1 about a quarter (granite a half) of them, within it
SKEW_BATCH, SKEW_SEQ, SKEW_VOCAB = 4, 512, 64
# the train steps; the prefill, decode and skewed forward
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
        raise RuntimeError(f'jax_ep_oracle: exit codes {codes}')
    out: dict = {}
    for part in parts:
        with np.load(part) as z:
            out.update(z)
        os.remove(part)
    np.savez(out_path, **out)


def batches(vocab: int, seed: int) -> dict:
    """``STEPS`` train batches of ``BATCH`` x ``SEQ`` (next-token labels,
    a share of them -1), one prefill batch, the decode tokens (one
    [DECODE_BATCH, 1] a step) and the skewed forward's tokens (rows 0
    and 1 from the first ``SKEW_VOCAB`` ids), numpy int32."""
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
    skew = rng.integers(SKEW_VOCAB, vocab, (SKEW_BATCH, SKEW_SEQ),
                        dtype=np.int32)
    skew[:2] = rng.integers(0, SKEW_VOCAB, (2, SKEW_SEQ), dtype=np.int32)
    out['skew'] = skew
    return out


def skew(p0: dict) -> dict:
    """``p0`` with feature 0 of the first ``SKEW_VOCAB`` embeddings at 1
    (0 for the others) and every layer's router weighing that feature by
    10 for expert 0: a token of those ids sends its first assignment to
    expert 0."""
    p = {k: (skew(v) if isinstance(v, dict) else np.array(v))
         for k, v in p0.items()}
    if 'embed' in p:
        p['embed'][:, 0] = 0.0
        p['embed'][:SKEW_VOCAB, 0] = 1.0
    if 'router' in p:
        p['router'][..., 0, 0] = 10.0
    return p


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
    from repro.models import moe
    from repro.optim import adam, schedule
    train_batches = [data[f'batch{i}'] for i in range(STEPS)]
    o_sh = adam.AdamState(step=repl, mu=p_sh, nu=p_sh)
    acfg = adam.AdamConfig(lr=LR, state_dtype=jnp.dtype(cfg.opt_state_dtype))

    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: moe.train_loss(p, batch, cfg, ctx))(params)
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
    """The prefill, the decode steps from zeroed caches and the skewed
    forward, each jitted with the layouts."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe, registry
    from repro.runtime.sharding import spec_to_sharding
    mesh = ctx.mesh
    prefill = jax.jit(registry.make_prefill(cfg, ctx),
                      in_shardings=(p_sh, b_sh(data['prefill'])),
                      out_shardings=repl)
    out[f'{arch}/logits'] = np.asarray(prefill(p0, data['prefill']))
    out[f'{arch}/prefill_tokens'] = data['prefill']['tokens']

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
    out[f'{arch}/k'], out[f'{arch}/v'] = (np.asarray(c) for c in state)
    out[f'{arch}/decode_tokens'] = data['decode']
    out[f'{arch}/cache_shard'] = np.asarray(
        s_sh[0].shard_shape(state[0].shape))

    sp = skew(p0)
    fwd = jax.jit(lambda p, t: moe.forward(p, t, cfg, ctx)[1],
                  in_shardings=(p_sh, b_sh(data['skew'])), out_shardings=repl)
    out[f'{arch}/skew_drop'] = np.asarray(fwd(sp, data['skew']))
    out[f'{arch}/skew_tokens'] = data['skew']
    out.update(flat(sp, f'{arch}/skew_p'))


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
