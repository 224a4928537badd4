"""The JAX package's partitioned encoder-decoder program (whisper-base,
recipe ``dp``) on 4 forced host devices, saved for the port's parity
tests (``tests/test_torch_mesh_encdec.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_encdec_oracle.py OUT.npz CASE[:PART]...

The test process holds JAX with one CPU device, so this runs in processes
of its own (``run``: one a case and part of ``PARTS``, side by side).  For
each reduced whisper of ``CASES`` on ``make_test_mesh`` (data 2, model
2), everything jitted with ``in_shardings`` and ``out_shardings`` from
``param_specs``, ``batch_shardings`` and ``decode_state_specs``:

  * the train step (``jax_ssm_oracle._train``: the train driver's, with
    its warmup schedule), ``STEPS`` steps on seeded numpy batches of
    tokens, labels and frames;
  * the prefill of seeded tokens and frames on the starting weights, and
    unpartitioned beside it;
  * ``prepare_cross`` of seeded frames, its pair laid out as the decode
    state's cross pair, then the decode step at each of ``POSITIONS``
    from zeroed self-attention caches of ``MAX_SEQ`` positions.

Saved under ``CASE/...``: the starting weights (``p0``), the batches,
frames and tokens, the losses and gradient norms, the prefill logits (and
``plain_logits``), the trained parameters and moments, the shard shape of
every parameter (``shard/...``), the cross pair gathered (``cross/0``,
``cross/1``), each decode step's logits, the decode state gathered
(``state/...``) and the shard shape of each of its leaves
(``state_shard/...``).
"""
import os
import subprocess
import sys

import numpy as np

from jax_ssm_oracle import BATCH, FLAGS, IGNORE_FRAC, SEQ, STEPS, flat

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = 'whisper-base'
# 2 encoder and 2 decoder layers, d_model 64, head_dim 32 (``reduced``);
# 4 heads split 2 a rank over 'model', 3 heads padded to 4, the padded
# head masked on the mesh (whisper-base's 8 heads on 16 ranks)
CASES = {'whisper-4': {'n_layers': 2, 'enc_layers': 2, 'd_model': 64,
                       'n_heads': 4, 'n_kv_heads': 4},
         'whisper-3': {'n_layers': 2, 'enc_layers': 2, 'd_model': 64,
                       'n_heads': 3, 'n_kv_heads': 3}}
S_ENC = 16                       # encoder frames a row (train, prefill)
PREFILL_BATCH, PREFILL_SEQ = 2, 32
DECODE_BATCH, MAX_SEQ = 4, 16    # the cross pair's length is MAX_SEQ too
POSITIONS = tuple(range(12))     # both blocks of the sequence (8 each)
PARTS = ('train', 'serve')


def config(case: str):
    """The JAX package's reduced whisper of ``case``."""
    from repro.configs import get_config
    return get_config(ARCH).reduced(**CASES[case])


def run(out_path, *cases) -> None:
    """Run each part of each case in a fresh process with 4 host devices,
    all side by side, and save their arrays together at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = (src + os.pathsep + HERE + os.pathsep
                         + env.get('PYTHONPATH', ''))
    jobs = [f'{case}:{part}' for case in cases for part in PARTS]
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
        raise RuntimeError(f'jax_encdec_oracle: exit codes {codes}')
    out: dict = {}
    for part in parts:
        with np.load(part) as z:
            out.update(z)
        os.remove(part)
    np.savez(out_path, **out)


def data(cfg, seed: int) -> dict:
    """``STEPS`` train batches of ``BATCH`` x ``SEQ`` tokens (next-token
    labels, a share of them -1) with ``S_ENC`` frames a row, the prefill's
    tokens and frames, the decode's frames and tokens (one [DECODE_BATCH,
    1] a step); numpy int32 and float32 (standard normal frames)."""
    rng = np.random.default_rng(seed)

    def frames(b):
        return rng.standard_normal((b, S_ENC, cfg.d_model)).astype(np.float32)

    out = {}
    for i in range(STEPS):
        t = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
        labels = t[:, 1:].copy()
        labels[rng.random(labels.shape) < IGNORE_FRAC] = -1
        out[f'batch{i}'] = {'tokens': t[:, :-1], 'labels': labels,
                            'frames': frames(BATCH)}
    out['prefill'] = {'tokens': rng.integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), dtype=np.int32),
        'frames': frames(PREFILL_BATCH)}
    out['decode_frames'] = rng.standard_normal(
        (DECODE_BATCH, MAX_SEQ, cfg.d_model)).astype(np.float32)
    out['decode'] = rng.integers(0, cfg.vocab,
                                 (len(POSITIONS), DECODE_BATCH, 1),
                                 dtype=np.int32)
    return out


def _serve(case: str, out: dict, cfg, ctx, p0, d: dict, p_sh, b_sh,
           repl) -> None:
    """The prefill, ``prepare_cross`` and the decode steps, each jitted
    with the layouts."""
    import jax
    import jax.numpy as jnp
    from repro.models import registry, whisper
    from repro.runtime.sharding import spec_to_sharding
    mesh = ctx.mesh
    prefill = jax.jit(registry.make_prefill(cfg, ctx),
                      in_shardings=(p_sh, b_sh(d['prefill'])),
                      out_shardings=repl)
    out[f'{case}/logits'] = np.asarray(prefill(p0, d['prefill']))
    out.update(flat(d['prefill'], f'{case}/prefill'))
    out[f'{case}/plain_logits'] = np.asarray(jax.jit(registry.make_prefill(
        cfg, registry.make_ctx(None, cfg)))(p0, d['prefill']))

    state = registry.init_decode_state(cfg, DECODE_BATCH, MAX_SEQ,
                                       registry.tp_of(mesh, cfg))
    s_sh = spec_to_sharding(mesh, registry.decode_state_specs(
        cfg, state, mesh, long_context=False))
    cross = jax.jit(lambda p, f: whisper.prepare_cross(p, f, cfg, ctx),
                    in_shardings=(p_sh, b_sh(d['decode_frames'])),
                    out_shardings=s_sh['cross'])(p0, d['decode_frames'])
    out.update({f'{case}/cross/{i}': np.asarray(c)
                for i, c in enumerate(cross)})
    state = dict(state, cross=cross)
    dstep = jax.jit(registry.make_decode_step(cfg, ctx),
                    in_shardings=(p_sh, b_sh(d['decode'][0]), s_sh, repl),
                    out_shardings=(repl, s_sh))
    logits = []
    for tok, pos in zip(d['decode'], POSITIONS):
        lg, state = dstep(p0, tok, state, jnp.int32(pos))
        logits.append(np.asarray(lg))
    out[f'{case}/decode_logits'] = np.stack(logits)
    out[f'{case}/decode_tokens'] = d['decode']
    out[f'{case}/decode_frames'] = d['decode_frames']
    for key in ('self', 'cross'):
        for i, (leaf, sh) in enumerate(zip(state[key], s_sh[key])):
            out[f'{case}/state/{key}/{i}'] = np.asarray(leaf)
            out[f'{case}/state_shard/{key}/{i}'] = np.asarray(
                sh.shard_shape(leaf.shape))


def case_run(case: str, part: str, out: dict) -> None:
    """``part`` of ``PARTS`` of ``case`` on (data 2, model 2), from the same
    weights and data in every part, saved into ``out``."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_test_mesh
    from repro.models import registry
    from repro.runtime.sharding import spec_to_sharding
    from jax_ssm_oracle import _train

    mesh = make_test_mesh((2, 2))
    cfg = config(case)
    ctx = registry.make_ctx(mesh, cfg)
    p0 = jax.tree.map(np.asarray, registry.init_params(
        jax.random.PRNGKey(0), cfg, registry.tp_of(mesh, cfg)))
    p_sh = spec_to_sharding(mesh, registry.param_specs(cfg, p0, mesh))

    def b_sh(tree):
        return spec_to_sharding(mesh, registry.batch_shardings(cfg, mesh,
                                                               tree))

    run_part = {'train': _train, 'serve': _serve}[part]
    run_part(case, out, cfg, ctx, p0, data(cfg, 1), p_sh, b_sh,
             NamedSharding(mesh, P()))


def main(argv) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f'need 4 host devices ({FLAGS}), have '
                         f'{len(jax.devices())}')
    out_path, jobs = argv[0], argv[1:]
    out: dict = {}
    for job in jobs:
        case, _, part = job.partition(':')
        for p in ([part] if part else PARTS):
            case_run(case, p, out)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == '__main__':
    main(sys.argv[1:])
