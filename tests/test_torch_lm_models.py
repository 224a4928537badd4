"""The port's dense-family LM (``repro_torch.models``) and its weights
carried across (``interop``) against the JAX package's, on the CPU.

For each of the five dense and vlm configs (yi-34b, command-r-35b,
smollm-360m, nemotron-4-15b, chameleon-34b), reduced: the JAX weights land
in the port bit for bit; ``forward``, ``prefill`` (logits and caches) and
``decode_step`` (logits and caches) agree with JAX's within 1e-5 absolute +
1e-5 relative in float32 (the same arithmetic summed in another order;
``flash_attention``'s bfloat16 roundings are the same in both); decode
agrees with forward on the port's own weights within JAX's 2e-2
(``tests/test_models.py::test_decode_matches_forward``); parameter shapes
at tp 2 equal JAX's, with q heads and vocab padded.  smollm also runs
padded at tp 2 against JAX, and in bfloat16 within 2 bfloat16 ulps of the
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import synthetic_batch
from repro.models import registry as jreg
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import registry as treg
from torch_serve_parity import one_torch_thread  # noqa: F401

DENSE = ('yi-34b', 'command-r-35b', 'smollm-360m', 'nemotron-4-15b',
         'chameleon-34b')
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 2 * 2.0 ** -7
B, S, MAX_SEQ = 2, 12, 16
# 15 q / 5 kv heads (smollm's) and a vocab off the TP multiple, so that tp 2
# pads both
ODD = dict(n_heads=15, n_kv_heads=5, d_model=120, head_dim=8, vocab=500)
jax_batch = jax.jit(synthetic_batch, static_argnums=(0, 1, 2, 3, 4))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _jax_run(cfg, params, toks, positions):
    """JAX's forward, prefill, and ``positions`` decode steps from a zeroed
    state, jitted; numpy results."""
    ctx = jreg.make_ctx(None, cfg)
    h = jax.jit(lambda p, t: jtr.forward(p, t, cfg, ctx))(params, toks)
    lg, caches = jax.jit(lambda p, t: jtr.prefill(p, t, cfg, ctx))(params,
                                                                    toks)
    step = jax.jit(jreg.make_decode_step(cfg, ctx))
    state = jreg.init_decode_state(cfg, toks.shape[0], MAX_SEQ)
    steps = []
    for t in range(positions):
        dlg, state = step(params, toks[:, t:t + 1], state, jnp.int32(t))
        steps.append(np.asarray(dlg))
    return dict(h=np.asarray(h), lg=np.asarray(lg), caches=_np_tree(caches),
                steps=steps, state=_np_tree(state))


@pytest.fixture(scope='module', params=DENSE)
def dense(request):
    """A reduced config's JAX weights and outputs, and the port's model on
    the same weights."""
    arch = request.param
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = tconfigs.get_config(arch).reduced()
    params = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    toks = jax_batch(0, 0, B, S, jcfg.vocab)['tokens']
    want = _jax_run(jcfg, params, toks, S)
    model = interop.lm_params_from_numpy(_np_tree(params), cfg, device='cpu')
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=_np_tree(params),
                model=model, toks=np.asarray(toks), want=want)


def test_interop_weights_are_exact(dense):
    model, params, cfg = dense['model'], dense['params'], dense['cfg']
    leaves = dict(model.named_parameters())
    for k, v in params['tok'].items():
        np.testing.assert_array_equal(leaves[f'tok.{k}'].detach().numpy(), v)
    n = len(params['tok'])
    for path, v in jax.tree_util.tree_leaves_with_path(params['blocks']):
        name = '.'.join(p.key for p in path)
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                leaves[f'blocks.{i}.{name}'].detach().numpy(), v[i])
        n += cfg.n_layers
    assert len(leaves) == n


def test_forward_prefill_decode_match_jax(dense):
    model, want = dense['model'], dense['want']
    toks = _t(dense['toks'])
    with torch.no_grad():
        _assert_close(model(toks), want['h'])
    lg, (k, v) = model.prefill(toks)
    _assert_close(lg, want['lg'])
    prefill = treg.make_prefill(dense['cfg'], treg.make_ctx(None,
                                                           dense['cfg']))
    assert torch.equal(prefill(model, {'tokens': toks}), lg)
    _assert_close(k, want['caches'][0])
    _assert_close(v, want['caches'][1])
    step = treg.make_decode_step(dense['cfg'], treg.make_ctx(None,
                                                             dense['cfg']))
    state = treg.init_decode_state(dense['cfg'], B, MAX_SEQ, device='cpu')
    for t, wlg in enumerate(want['steps']):
        lg, out = step(model, toks[:, t:t + 1], state, t)
        assert out[0] is state[0] and out[1] is state[1]     # in place
        _assert_close(lg, wlg)
    _assert_close(state[0], want['state'][0])
    _assert_close(state[1], want['state'][1])
    # layer 0's K/V depend only on the embeddings: prefill's equal the
    # decode steps'
    _assert_close(state[0][0, :, :S], want['caches'][0][0])
    _assert_close(state[1][0, :, :S], want['caches'][1][0])


def test_decode_matches_forward_on_the_port(dense):
    """``tests/test_models.py::test_decode_matches_forward``'s property on
    the port's own weights (seed 1) and tokens, at JAX's 2e-2."""
    cfg = dense['cfg']
    model = treg.init_params(1, cfg, device='cpu')
    toks = _t(dense['toks'])
    with torch.no_grad():
        lg_fwd = model.logits(model(toks)[:, -1:])[:, 0]
    state = treg.init_decode_state(cfg, B, S + 4, device='cpu')
    for t in range(S):
        lg, state = model.decode_step(toks[:, t:t + 1], state, t)
    np.testing.assert_allclose(lg.numpy(), lg_fwd.numpy(), atol=2e-2,
                               rtol=2e-2)
    prefill_lg, _ = model.prefill(toks)
    np.testing.assert_allclose(prefill_lg.numpy(), lg_fwd.numpy(), **TOL)


@pytest.mark.parametrize('tp', [1, 2])
@pytest.mark.parametrize('arch', DENSE)
def test_param_shapes_match_jax(arch, tp):
    """At tp 2, 15 q heads pad to 16 and a 500 vocab to 512; every
    parameter's shape and dtype equal JAX's (less the [L] axis)."""
    jcfg = jconfigs.get_config(arch).reduced(**ODD)
    cfg = tconfigs.get_config(arch).reduced(**ODD)
    abstract = jreg.abstract_params(jcfg, tp=tp)
    model = treg.init_params(0, cfg, tp=tp, device='cpu')
    got = {k: (tuple(v.shape), str(v.dtype).split('.')[-1])
           for k, v in model.named_parameters()}
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        keys = [p.key for p in path]
        if keys[0] == 'blocks':
            for i in range(cfg.n_layers):
                name = '.'.join(['blocks', str(i)] + keys[1:])
                assert got.pop(name) == (leaf.shape[1:], leaf.dtype.name), name
        else:
            assert got.pop('.'.join(keys)) == (leaf.shape, leaf.dtype.name)
    assert not got
    assert model.blocks[0].attn['wq'].shape[1] == (16 if tp == 2 else 15) * 8
    assert model.tok['embed'].shape[0] == (512 if tp == 2 else 500)


def test_tp2_padded_heads_and_vocab_match_jax():
    """smollm's 15 q heads padded to 16 (masked) and a 500 vocab to 512
    (masked logits) at tp 2: prefill and decode agree with JAX's on JAX's
    weights."""
    jcfg = jconfigs.get_config('smollm-360m').reduced(**ODD)
    cfg = tconfigs.get_config('smollm-360m').reduced(**ODD)
    params = jreg.init_params(jax.random.PRNGKey(2), jcfg, tp=2)
    toks = jax_batch(1, 0, B, 6, jcfg.vocab)['tokens']
    want = _jax_run(jcfg, params, toks, 3)
    port = interop.lm_params_from_numpy(_np_tree(params), cfg, device='cpu')
    lg, _ = port.prefill(_t(toks))
    _assert_close(lg, want['lg'])
    assert float(lg[:, cfg.vocab:].max()) <= -1e29
    state = treg.init_decode_state(cfg, B, MAX_SEQ, tp=2, device='cpu')
    for t, wlg in enumerate(want['steps']):
        lg, state = port.decode_step(_t(toks)[:, t:t + 1], state, t)
        _assert_close(lg, wlg)


def test_bfloat16_model_matches_jax():
    """smollm reduced in bfloat16: the bf16 weights carry over bit for bit
    (``ml_dtypes`` arrays viewed as uint16), and forward, prefill and a
    decode step agree within 2 bfloat16 ulps of the logits' magnitude."""
    jcfg = jconfigs.get_config('smollm-360m').reduced(dtype='bfloat16')
    cfg = tconfigs.get_config('smollm-360m').reduced(dtype='bfloat16')
    params = jreg.init_params(jax.random.PRNGKey(3), jcfg)
    toks = jax_batch(2, 0, B, 8, jcfg.vocab)['tokens']
    want = _jax_run(jcfg, params, toks, 8)
    model = interop.lm_params_from_numpy(_np_tree(params), cfg, device='cpu')
    wq = np.asarray(params['blocks']['attn']['wq'][1])
    got = model.blocks[1].attn['wq'].detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))

    def close(got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=BF16_REL * scale, rtol=0)

    with torch.no_grad():
        close(model(_t(toks)), want['h'])
    lg, caches = model.prefill(_t(toks))
    close(lg, want['lg'])
    close(caches[0], want['caches'][0])
    state = interop.kv_cache_from_numpy(
        jreg.init_decode_state(jcfg, B, MAX_SEQ), device='cpu')
    assert state[0].dtype == torch.bfloat16
    for t, wlg in enumerate(want['steps']):
        lg, state = model.decode_step(_t(toks)[:, t:t + 1], state, t)
        close(lg, wlg)
