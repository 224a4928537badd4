"""The port's recurrent cores against the JAX package's, on the CPU: the
chunkwise linear attention and its decode step (``models.linear_scan``),
the Mamba2 layer (``models.mamba2``) and the mLSTM and sLSTM blocks
(``models.xlstm``), each on the same seeded inputs and the same weights,
within 1e-5 absolute + 1e-5 relative (float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import linear_scan as jscan
from repro.models import mamba2 as jmamba
from repro.models import registry as jreg
from repro.models import xlstm as jxlstm

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import linear_scan as tscan
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import xlstm as txlstm
from torch_lm_parity import assert_close, jax_init, np_tree, t
from torch_serve_parity import one_torch_thread  # noqa: F401


def _scan_inputs(seed, b=2, s=24, h=2, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32)
    return q, k, v, log_a


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('s,chunk,with_state', [
    (24, 8, False),      # three chunks of 8
    (24, 8, True),       # the same from a carried-in state
    (21, 8, False),      # 21 % 8: the width falls to 7
    (13, 512, True)])    # one chunk of a prime length
def test_chunked_linear_attention_matches_jax(normalize, s, chunk,
                                              with_state):
    q, k, v, log_a = _scan_inputs(s, s=s)
    state = None
    if with_state:
        state = np.random.default_rng(1).standard_normal(
            (2, 2, 8, 9 if normalize else 8)).astype(np.float32)
    y, st = jscan.chunked_linear_attention(
        q, k, v, log_a, chunk=chunk, normalize=normalize,
        state_in=None if state is None else jnp.asarray(state))
    ty, tst = tscan.chunked_linear_attention(
        t(q), t(k), t(v), t(log_a), chunk=chunk, normalize=normalize,
        state_in=None if state is None else t(state))
    assert_close(ty, y)
    assert_close(tst, st)


@pytest.mark.parametrize('normalize', [False, True])
def test_linear_attention_step_matches_jax_and_chunked(normalize):
    """Each step against JAX's step within 1e-5; the port's steps against
    its own chunked form within JAX's ``atol=2e-4, rtol=2e-3``
    (``tests/test_models.py::test_chunked_linear_attention_matches_step``)."""
    q, k, v, log_a = _scan_inputs(3)
    b, s, h, dk = q.shape
    st = np.zeros((b, h, dk, 9 if normalize else 8), np.float32)
    jst, tst = jnp.asarray(st), t(st)
    ys = []
    for i in range(s):
        y, jst = jscan.linear_attention_step(jst, q[:, i], k[:, i], v[:, i],
                                             log_a[:, i], normalize=normalize)
        ty, tst = tscan.linear_attention_step(
            tst, t(q[:, i]), t(k[:, i]), t(v[:, i]), t(log_a[:, i]),
            normalize=normalize)
        assert_close(ty, y)
        assert_close(tst, jst)
        ys.append(ty)
    y_par, st_par = tscan.chunked_linear_attention(
        t(q), t(k), t(v), t(log_a), chunk=8, normalize=normalize)
    np.testing.assert_allclose(y_par.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(st_par.numpy(), tst.numpy(), atol=2e-4,
                               rtol=2e-3)


def _tensors(p: dict) -> dict:
    return {k: t(v) for k, v in p.items()}


@pytest.fixture(scope='module')
def zamba():
    jcfg = jconfigs.get_config('zamba2-1.2b').reduced()
    cfg = tconfigs.get_config('zamba2-1.2b').reduced()
    p = jmamba.mamba_params(jax.random.PRNGKey(4), jcfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, _tensors(p), x


def test_mamba_block_and_decode_match_jax(zamba):
    """``mamba_block`` over 10 tokens, then 10 ``mamba_decode`` steps from a
    zeroed state (their conv cache and SSD state each step), on the same
    input rows."""
    jcfg, cfg, p, tp, x = zamba
    ctx = jreg.make_ctx(None, jcfg)
    assert_close(tmamba.mamba_block(tp, t(x), cfg),
                 jax.jit(lambda p, x: jmamba.mamba_block(p, x, jcfg, ctx))(
                     p, x))
    jst = jmamba.init_state(jcfg, 2)
    tst = tmamba.init_state(cfg, 2, device='cpu')
    decode = jax.jit(lambda p, x, st: jmamba.mamba_decode(p, x, st, jcfg,
                                                          ctx))
    assert {k: (tuple(v.shape), str(v.dtype).split('.')[-1])
            for k, v in tst.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in jst.items()}
    for i in range(x.shape[1]):
        y, jst = decode(p, x[:, i:i + 1], jst)
        ty, tst = tmamba.mamba_decode(tp, t(x[:, i:i + 1]), tst, cfg)
        assert_close(ty, y)
        for key in ('ssm', 'conv'):
            assert_close(tst[key], jst[key])


def test_mamba_inputs_and_conv_match_jax(zamba):
    """``_ssm_inputs`` (q, k, v rounded after the dt product, log_a, z, the
    skip term) and the causal conv with and without its cache."""
    jcfg, cfg, p, tp, x = zamba
    want = jmamba._ssm_inputs(p, jnp.asarray(x), jcfg)
    got = tmamba._ssm_inputs(tp, t(x), cfg)
    for g, w in zip(got[:6], want[:6]):
        assert_close(g, w)
    assert float(got[3].max()) <= 0.0
    xbc = np.random.default_rng(5).standard_normal((2, 6, 20)).astype(
        np.float32)
    w = np.random.default_rng(6).standard_normal((4, 20)).astype(np.float32)
    out, _ = jmamba._causal_conv(jnp.asarray(xbc), jnp.asarray(w))
    tout, none = tmamba._causal_conv(t(xbc), t(w))
    assert none is None
    assert_close(tout, out)
    cache = xbc[:, :3]
    out, new = jmamba._causal_conv(jnp.asarray(xbc[:, 3:4]), jnp.asarray(w),
                                   jnp.asarray(cache))
    tout, tnew = tmamba._causal_conv(t(xbc[:, 3:4]), t(w), t(cache))
    assert_close(tout, out)
    assert_close(tnew, new)
    # the cached step equals the full conv at that position
    assert_close(tout[:, 0], tmamba._causal_conv(t(xbc), t(w))[0][:, 3])


@pytest.fixture(scope='module')
def xlstm():
    jcfg = jconfigs.get_config('xlstm-1.3b').reduced()
    cfg = tconfigs.get_config('xlstm-1.3b').reduced()
    km, ks = jax.random.split(jax.random.PRNGKey(5))
    blk = {'mlstm': jxlstm.mlstm_params(km, jcfg, jnp.float32),
           'slstm': jxlstm.slstm_params(ks, jcfg, jnp.float32)}
    x = np.random.default_rng(7).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, blk, {k: _tensors(v) for k, v in blk.items()}, x


def test_mlstm_block_and_decode_match_jax(xlstm):
    jcfg, cfg, blk, tblk, x = xlstm
    ctx = jreg.make_ctx(None, jcfg)
    p, tp = blk['mlstm'], tblk['mlstm']
    for g, w in zip(txlstm._mlstm_qkvg(tp, t(x), cfg),
                    jxlstm._mlstm_qkvg(p, jnp.asarray(x), jcfg, ctx)):
        assert_close(g, w)
    assert_close(txlstm.mlstm_block(tp, t(x), cfg),
                 jax.jit(lambda p, x: jxlstm.mlstm_block(p, x, jcfg, ctx))(
                     p, x))
    hd = 2 * cfg.d_model // cfg.n_heads
    st = np.zeros((2, cfg.n_heads, hd, hd + 1), np.float32)
    jst, tst = jnp.asarray(st), t(st)
    decode = jax.jit(lambda p, x, st: jxlstm.mlstm_decode(p, x, st, jcfg,
                                                          ctx))
    for i in range(x.shape[1]):
        y, jst = decode(p, x[:, i:i + 1], jst)
        ty, tst = txlstm.mlstm_decode(tp, t(x[:, i:i + 1]), tst, cfg)
        assert_close(ty, y)
        assert_close(tst, jst)


def test_slstm_block_and_decode_match_jax(xlstm):
    """The sequential sLSTM block against JAX's two-level chunked scan,
    the gate-major reshape of ``_slstm_recur`` included, then its decode
    steps (h, c) from zeros."""
    jcfg, cfg, blk, tblk, x = xlstm
    ctx = jreg.make_ctx(None, jcfg)
    p, tp = blk['slstm'], tblk['slstm']
    assert_close(txlstm.slstm_block(tp, t(x), cfg),
                 jax.jit(lambda p, x: jxlstm.slstm_block(p, x, jcfg, ctx))(
                     p, x))
    di = 2 * cfg.d_model
    rng = np.random.default_rng(8)
    pre = rng.standard_normal((2, 4 * di)).astype(np.float32)
    h, c = (rng.standard_normal((2, di)).astype(np.float32)
            for _ in range(2))
    w32 = np.asarray(p['w_h_blocks'], np.float32)
    hd = di // cfg.n_heads
    for g, w in zip(txlstm._slstm_recur(t(pre), t(h), t(c), t(w32),
                                        cfg.n_heads, hd),
                    jxlstm._slstm_recur(pre, h, c, w32, cfg.n_heads, hd)):
        assert_close(g, w)
    zero = np.zeros((2, di), np.float32)
    jst, tst = (zero, zero), (t(zero), t(zero))
    decode = jax.jit(lambda p, x, st: jxlstm.slstm_decode(p, x, st, jcfg,
                                                          ctx))
    for i in range(x.shape[1]):
        y, jst = decode(p, x[:, i:i + 1], jst)
        ty, tst = txlstm.slstm_decode(tp, t(x[:, i:i + 1]), tst, cfg)
        assert_close(ty, y)
        for g, w in zip(tst, jst):
            assert_close(g, w)


def test_xlstm_without_super_blocks_refuses_to_decode():
    """A depth that ``slstm_every`` does not divide: one stack of mLSTM
    blocks, whose forward equals JAX's; the reference's decode reads an
    sLSTM block that does not exist, and the port raises there."""
    kw = dict(n_layers=3, slstm_every=2)
    jcfg = jconfigs.get_config('xlstm-1.3b').reduced(**kw)
    cfg = tconfigs.get_config('xlstm-1.3b').reduced(**kw)
    assert txlstm._super(cfg) == jxlstm._super(jcfg) == (1, 0)
    params = jax_init(6, jcfg)
    model = interop.lm_params_from_numpy(np_tree(params), cfg, device='cpu')
    assert len(model.blocks) == 3 and 'wq' in model.blocks[2]
    toks = np.arange(10, dtype=np.int32).reshape(2, 5)
    with torch.no_grad():
        got = model(t(toks))
    assert_close(got, jxlstm.forward(params, toks, jcfg,
                                     jreg.make_ctx(None, jcfg)))
    state = txlstm.init_state(cfg, 2, device='cpu')
    assert tuple(state['mlstm'].shape) == \
        jxlstm.init_state(jcfg, 2)['mlstm'].shape
    with pytest.raises(ValueError, match='xlstm-1.3b: slstm_every=2'):
        model.decode_step(t(toks[:, :1]), state, 0)
