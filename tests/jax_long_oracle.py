"""The JAX package's long-context decode (the ``long_500k`` layout:
``make_ctx(long_context=True)``, ``decode_state_specs(long_context=True)``)
on 4 forced host devices, saved for the port's parity tests
(``tests/test_torch_mesh_long.py``).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/jax_long_oracle.py OUT.npz CASE...

The test process holds JAX with one CPU device, so this runs in processes
of its own (``run``: one a case, side by side).  For each reduced config
of ``CASES`` on ``make_test_mesh`` (data 2, model 2), at batch 1 as
``long_500k`` runs: the decode step jitted with ``in_shardings``
(parameters by ``param_specs``, the token by ``batch_shardings``, the
zeroed state by the long-context ``decode_state_specs``: zamba2's caches
[pts, 1, T, H, hd] with the sequence over ``data`` and the heads, else
head_dim, over ``model``; xlstm's recurrent states as at any shape, dk
over ``model``) and ``out_shardings`` (logits replicated, the state as it
came), one step at each position of ``POSITIONS`` on seeded numpy tokens.
Saved under ``CASE/...``: the starting weights (``p0``), the tokens, each
step's logits, the state after the last step gathered (``state/...``)
and the shard shape of each of its leaves (``state_shard/...``).
"""
import os
import subprocess
import sys

import numpy as np

from jax_ssm_oracle import FLAGS, flat

HERE = os.path.dirname(os.path.abspath(__file__))
# zamba2 (4 Mamba2 layers, two attention points): 4 kv heads, which
# 'model' (2) divides, so the caches split their heads (zamba2-1.2b's 32
# on 16 ranks); 3, which it does not, so they split head_dim (32, 16 a
# rank).  xlstm: 3 heads, so the mLSTM state splits dk, as in
# jax_ssm_oracle
CASES = {'zamba2-kv4': ('zamba2-1.2b', {'n_layers': 4, 'n_heads': 4,
                                        'n_kv_heads': 4}),
         'zamba2-kv3': ('zamba2-1.2b', {'n_layers': 4, 'n_heads': 3,
                                        'n_kv_heads': 3}),
         'xlstm': ('xlstm-1.3b', {'n_layers': 4, 'd_model': 96,
                                  'n_heads': 3})}
BATCH, MAX_SEQ = 1, 16
# both blocks of the caches' sequence over 'data' (8 each); every write
# lands inside the cache (a clamped write past its end is a fault of the
# reference's partitioned step, ROADMAP queue 3)
POSITIONS = tuple(range(12))


def run(out_path, *cases) -> None:
    """Run each case in a fresh process with 4 host devices, all side by
    side, and save their arrays together at ``out_path``."""
    env = dict(os.environ, XLA_FLAGS=FLAGS, JAX_PLATFORMS='cpu')
    src = os.path.join(os.path.dirname(HERE), 'src')
    env['PYTHONPATH'] = (src + os.pathsep + HERE + os.pathsep
                         + env.get('PYTHONPATH', ''))
    parts = [f'{out_path}.{i}.npz' for i in range(len(cases))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               part, case], env=env)
             for part, case in zip(parts, cases)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f'jax_long_oracle: exit codes {codes}')
    out: dict = {}
    for part in parts:
        with np.load(part) as z:
            out.update(z)
        os.remove(part)
    np.savez(out_path, **out)


def case_run(case: str, out: dict) -> None:
    """The decode steps of ``case`` on (data 2, model 2) from a zeroed
    state, saved into ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import registry
    from repro.runtime.sharding import spec_to_sharding

    arch, over = CASES[case]
    mesh = make_test_mesh((2, 2))
    cfg = get_config(arch).reduced(**over)
    ctx = registry.make_ctx(mesh, cfg, long_context=True)
    tp = registry.tp_of(mesh, cfg)
    p0 = jax.tree.map(np.asarray, registry.init_params(
        jax.random.PRNGKey(0), cfg, tp))
    p_sh = spec_to_sharding(mesh, registry.param_specs(cfg, p0, mesh))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (len(POSITIONS), BATCH, 1), dtype=np.int32)
    state = registry.init_decode_state(cfg, BATCH, MAX_SEQ, tp)
    s_sh = spec_to_sharding(mesh, registry.decode_state_specs(
        cfg, state, mesh, long_context=True))
    t_sh = spec_to_sharding(mesh, registry.batch_shardings(cfg, mesh,
                                                           toks[0]))
    repl = NamedSharding(mesh, P())
    dstep = jax.jit(registry.make_decode_step(cfg, ctx),
                    in_shardings=(p_sh, t_sh, s_sh, repl),
                    out_shardings=(repl, s_sh))
    logits = []
    for tok, pos in zip(toks, POSITIONS):
        lg, state = dstep(p0, tok, state, jnp.int32(pos))
        logits.append(np.asarray(lg))
    out.update(flat(p0, f'{case}/p0'))
    out[f'{case}/tokens'] = toks
    out[f'{case}/decode_logits'] = np.stack(logits)
    out.update(flat(jax.tree.map(np.asarray, state), f'{case}/state'))
    out.update(flat(jax.tree.map(
        lambda a, s: np.asarray(s.shard_shape(a.shape)), state, s_sh),
        f'{case}/state_shard'))


def main(argv) -> None:
    import jax
    if len(jax.devices()) < 4:
        raise SystemExit(f'need 4 host devices ({FLAGS}), have '
                         f'{len(jax.devices())}')
    out_path, cases = argv[0], argv[1:]
    out: dict = {}
    for case in cases:
        case_run(case, out)
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == '__main__':
    main(sys.argv[1:])
