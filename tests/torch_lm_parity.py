"""Helpers for the parity tests of the port's LM families
(``tests/test_torch_lm_{scan,moe,families,serve_families}.py``): the same
seeded inputs through the JAX package and the port, on the CPU.

Tolerances.  Every module of the port, given the same inputs as JAX's,
agrees within ``TOL`` (1e-5 absolute + 1e-5 relative, float32).  Through a
whole model the two sides feed each layer inputs that differ in the last
float32 bit (XLA's rsqrt and reduction order are not torch's), and
``flash_attention`` rounds Q x scale, K, P and V to bfloat16 as the
reference does: where such a bit sits on a bfloat16 rounding boundary, the
operand moves by one bfloat16 ulp (2^-8 relative).  On the fixtures here
that moved whisper's and maverick's logits by up to 1.0e-4 (logits up to
0.8); the families whose path has no such rounding (xlstm) or met none
(granite, zamba2) stay within 1e-6.  ``FLIP_TOL`` (2e-4 absolute) bounds
the whole-model comparisons of the families with attention.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data.tokens import synthetic_batch
from repro.models import registry as jreg
from repro.models import whisper as jwhisper

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import registry as treg

FAMILIES = ('granite-moe-1b-a400m', 'llama4-maverick-400b-a17b',
            'whisper-base', 'xlstm-1.3b', 'zamba2-1.2b')
TOL = dict(atol=1e-5, rtol=1e-5)
FLIP_TOL = dict(atol=2e-4, rtol=1e-5)
B, S, MAX_SEQ, S_ENC = 2, 12, 16, 16
jax_batch = jax.jit(synthetic_batch, static_argnums=(0, 1, 2, 3, 4))


def jax_init(seed: int, jcfg, tp: int = 1):
    """JAX's random weights for ``jcfg`` from ``PRNGKey(seed)``, jitted."""
    return jax.jit(lambda key: jreg.init_params(key, jcfg, tp))(
        jax.random.PRNGKey(seed))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def family_tol(cfg) -> dict:
    """``TOL`` where the model has no attention, else ``FLIP_TOL``."""
    return TOL if cfg.family == 'ssm' else FLIP_TOL


def batch(jcfg, seed: int, b: int = B, s: int = S) -> dict:
    """Seeded tokens [b, s], and for ``encdec`` seeded frames [b, S_ENC,
    D] (numpy, standard normal)."""
    out = {'tokens': np.asarray(jax_batch(seed, 0, b, s, jcfg.vocab)['tokens'])}
    if jcfg.family == 'encdec':
        out['frames'] = np.random.default_rng(seed).standard_normal(
            (b, S_ENC, jcfg.d_model)).astype(np.float32)
    return out


def jax_hidden(jcfg, params, data):
    """JAX's final hidden states of the teacher-forced pass."""
    ctx = jreg.make_ctx(None, jcfg)
    mod = jreg.module_for(jcfg)
    if jcfg.family == 'encdec':
        enc = jwhisper.encode(params, data['frames'], jcfg, ctx)
        return jwhisper.decode_train(params, data['tokens'], enc, jcfg, ctx)
    h = mod.forward(params, data['tokens'], jcfg, ctx)
    return h[0] if jcfg.family == 'moe' else h


def port_hidden(model, data):
    tb = {k: t(v) for k, v in data.items()}
    with torch.no_grad():
        if model.cfg.family == 'encdec':
            return model.decode_train(tb['tokens'], model.encode(tb['frames']))
        h = model(tb['tokens'])
    return h[0] if model.cfg.family == 'moe' else h


def jax_run(jcfg, params, data, steps: int) -> dict:
    """JAX's forward, prefill, and ``steps`` teacher-forced decode steps
    from a zeroed state (``prepare_cross`` of the frames for encdec),
    jitted; numpy results."""
    ctx = jreg.make_ctx(None, jcfg)
    h = jax.jit(lambda p, d: jax_hidden(jcfg, p, d))(params, data)
    lg = jax.jit(jreg.make_prefill(jcfg, ctx))(params, data)
    step = jax.jit(jreg.make_decode_step(jcfg, ctx))
    state = jreg.init_decode_state(jcfg, B, MAX_SEQ)
    if jcfg.family == 'encdec':
        state['cross'] = jwhisper.prepare_cross(params, data['frames'], jcfg,
                                                ctx)
    toks = data['tokens']
    lgs = []
    for i in range(steps):
        dlg, state = step(params, toks[:, i:i + 1], state, jnp.int32(i))
        lgs.append(np.asarray(dlg))
    return dict(h=np.asarray(h), lg=np.asarray(lg), steps=lgs,
                state=np_tree(state))


def port_state(model, cfg, data, b: int, max_seq: int):
    """The port's zeroed decode state, with ``prepare_cross`` of the
    frames for encdec."""
    state = treg.init_decode_state(cfg, b, max_seq, device='cpu')
    if cfg.family == 'encdec':
        state['cross'] = model.prepare_cross(t(data['frames']))
    return state


@functools.cache
def family(arch: str, seed: int = 0) -> dict:
    """A reduced config's JAX weights and outputs (12 decode steps), and
    the port's model on the same weights (made once a process)."""
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = tconfigs.get_config(arch).reduced()
    params = jax_init(seed, jcfg)
    data = batch(jcfg, seed)
    want = jax_run(jcfg, params, data, S)
    model = interop.lm_params_from_numpy(np_tree(params), cfg, device='cpu')
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=np_tree(params),
                model=model, data=data, want=want)


def check_family_matches_jax(fam) -> None:
    """Forward, prefill and 12 decode steps (logits, then the final
    state) of the port against JAX's, on JAX's weights."""
    cfg, model, data, want = fam['cfg'], fam['model'], fam['data'], \
        fam['want']
    tol = family_tol(cfg)
    assert_close(port_hidden(model, data), want['h'], tol)
    prefill = treg.make_prefill(cfg, treg.make_ctx(None, cfg))
    assert_close(prefill(model, {k: t(v) for k, v in data.items()}),
                 want['lg'], tol)
    step = treg.make_decode_step(cfg, treg.make_ctx(None, cfg))
    state = port_state(model, cfg, data, B, MAX_SEQ)
    toks = t(data['tokens'])
    for i, wlg in enumerate(want['steps']):
        lg, state = step(model, toks[:, i:i + 1], state, i)
        assert_close(lg, wlg, tol)
    got = jax.tree_util.tree_leaves(state)
    wanted = jax.tree_util.tree_leaves(want['state'])
    assert len(got) == len(wanted)
    for g, w in zip(got, wanted):
        assert_close(g, w, tol)


def check_decode_matches_forward(arch: str) -> None:
    """``tests/test_models.py::test_decode_matches_forward``'s property on
    the port's own weights (seed 1), at JAX's 2e-2: 12 tokens decoded one
    at a time end at the teacher-forced pass's last logits (whisper:
    ``decode_step`` over ``prepare_cross`` against ``decode_train``)."""
    cfg = tconfigs.get_config(arch).reduced()
    model = treg.init_params(1, cfg, device='cpu')
    data = batch(cfg, 1)
    with torch.no_grad():
        lg_fwd = model.logits(port_hidden(model, data)[:, -1:])[:, 0]
    state = port_state(model, cfg, data, B, S + 4)
    step = treg.make_decode_step(cfg, treg.make_ctx(None, cfg))
    toks = t(data['tokens'])
    for i in range(S):
        lg, state = step(model, toks[:, i:i + 1], state, i)
    np.testing.assert_allclose(lg.numpy(), lg_fwd.numpy(), atol=2e-2,
                               rtol=2e-2)


def split_name(name: str) -> tuple:
    """A port parameter's name as (the JAX tree's keys, the indices into
    the leaf's stacked leading axes)."""
    parts = name.split('.')
    return ([p for p in parts if not p.isdigit()],
            tuple(int(p) for p in parts if p.isdigit()))


def leaf_of(tree, name: str):
    """The JAX leaf (numpy) that the port's parameter ``name`` holds."""
    keys, idx = split_name(name)
    for key in keys:
        tree = tree[key]
    return np.asarray(tree)[idx]


def jax_sizes(tree) -> int:
    return sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(tree))
