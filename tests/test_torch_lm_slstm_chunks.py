"""The sLSTM walk in chunks (``models.xlstm._slstm_scan``), on the CPU.

The JAX package walks time in two levels: chunks of ``w`` steps (the
largest divisor of S that is at most 256), each converted to float32 once
and wrapped in ``jax.checkpoint``, so its backward keeps only the (h, c)
carries between chunks.  The port walks the same chunks under
``layers.remat``.  At reduced width (d_model 128, di 256, 4 heads) and S =
520 (w = 130, four chunks) and S = 9 (one chunk):

  (a) ``slstm_block``'s output and its gradients (x, ``ln``, ``w_x``,
      ``w_h_blocks``, ``w_down``) against ``jax.grad`` of JAX's block,
      within ``TOL`` (float32);
  (b) the forward equals the one-loop walk that the port ran before the
      chunks (``flat_scan`` below) bit for bit, in float32 and bfloat16;
  (c) the bytes that ``saved_tensors_hooks`` sees during the walk's
      forward with grad on, less its inputs', stay below one chunk's
      float32 intermediates plus the carries (fails where no checkpoint
      is in effect);
  (d) under ``torch.no_grad()`` nothing is checkpointed, and the values
      are those of the forward with grad on; with grad on each chunk is
      checkpointed where there are several, and a walk of one chunk runs
      plain, as the other chunk loops of the port do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models import xlstm as jxlstm

from repro_torch import configs as tconfigs
from repro_torch.analysis.op_count import saved_bytes
from repro_torch.models import layers as L
from repro_torch.models import xlstm as txlstm
from torch_lm_parity import assert_close, t
from torch_serve_parity import one_torch_thread  # noqa: F401

B = 2
# (S, w): four chunks of 130; one chunk of a length under 256
LENGTHS = ((520, 130), (9, 9))
# float32 against JAX: the output and every gradient within
# torch_lm_parity.TOL (1e-5 absolute + 1e-5 relative); the largest gap
# seen is 6.7e-6 on w_down's gradient (entries up to 9.2) at S = 520
PARAMS = ('ln', 'w_x', 'w_h_blocks', 'w_down')


def flat_scan(pre_x, w_h_blocks, n_heads: int):
    """The port's walk before the chunks: one loop over all S steps, one
    float32 conversion a step, nothing checkpointed."""
    b, s, di4 = pre_x.shape
    di = di4 // 4
    w32 = w_h_blocks.float()
    h = torch.zeros((b, di), dtype=torch.float32, device=pre_x.device)
    c = torch.zeros_like(h)
    hs = []
    for i in range(s):
        h, c = txlstm._slstm_recur(pre_x[:, i].float(), h, c, w32, n_heads,
                                   di // n_heads)
        hs.append(h.to(pre_x.dtype))
    return torch.stack(hs, dim=1)


@pytest.fixture(scope='module')
def slstm():
    jcfg = jconfigs.get_config('xlstm-1.3b').reduced()
    cfg = tconfigs.get_config('xlstm-1.3b').reduced()
    p = jxlstm.slstm_params(jax.random.PRNGKey(11), jcfg, jnp.float32)
    # a ln scale away from ones, so its gradient is not a plain sum
    p['ln'] = p['ln'] * (1 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(12), p['ln'].shape))
    return jcfg, cfg, p


def _inputs(cfg, s: int):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return x, ct


def _port_params(p, dtype=torch.float32) -> dict:
    return {k: t(np.asarray(v)).to(dtype).requires_grad_() for k, v in
            p.items()}


def test_slstm_chunk_is_jax_divisor():
    for s, w in LENGTHS + ((4096, 256), (32768, 256), (300, 150),
                           (257, 1), (7 * 37, 37)):
        assert txlstm.slstm_chunk(s) == w
        assert s % w == 0


@pytest.mark.parametrize('s,w', LENGTHS)
def test_block_and_gradients_match_jax(slstm, s, w):
    """(a) the output and every gradient against ``jax.grad``."""
    jcfg, cfg, p = slstm
    x, ct = _inputs(cfg, s)
    ctx = jreg.make_ctx(None, jcfg)

    def loss(p, x):
        y = jxlstm.slstm_block(p, x, jcfg, ctx)
        return jnp.sum(y * ct), y

    (_, want_y), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = _port_params(p)
    tx = t(x).requires_grad_()
    y = txlstm.slstm_block(tp, tx, cfg)
    assert_close(y, want_y)
    grads = torch.autograd.grad((y * t(ct)).sum(),
                                [tx] + [tp[k] for k in PARAMS])
    assert_close(grads[0], want_gx)
    for k, g in zip(PARAMS, grads[1:]):
        assert_close(g, want_gp[k])


@pytest.mark.parametrize('dtype', (torch.float32, torch.bfloat16))
@pytest.mark.parametrize('s,w', LENGTHS)
def test_forward_equals_the_flat_walk(slstm, s, w, dtype, monkeypatch):
    """(b) the block's output, with grad on and off, bit for bit the one
    of the one-loop walk."""
    _, cfg, p = slstm
    x, _ = _inputs(cfg, s)
    tp = _port_params(p, dtype)
    tx = t(x).to(dtype)
    got = txlstm.slstm_block(tp, tx, cfg)
    with torch.no_grad():
        got_ng = txlstm.slstm_block(tp, tx, cfg)
    monkeypatch.setattr(txlstm, '_slstm_scan', flat_scan)
    want = txlstm.slstm_block(tp, tx, cfg)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got_ng, want)


def test_walk_saves_at_most_one_chunk(slstm):
    """(c) at S = 520 the chunked walk's forward leaves autograd less than
    one chunk's float32 intermediates (its first chunk walked without a
    checkpoint, about 130 / 520 of the flat walk's) plus the four chunks'
    carries; the flat walk itself is far above that."""
    _, cfg, p = slstm
    s, w = LENGTHS[0]
    di = 2 * cfg.d_model
    rng = np.random.default_rng(3)
    pre = t(rng.standard_normal((B, s, 4 * di)).astype(np.float32))
    w_h = t(np.asarray(p['w_h_blocks'])).requires_grad_()
    pre.requires_grad_()
    ins = (pre, w_h)
    flat, want = saved_bytes(flat_scan, pre, w_h, 4, inputs=ins)
    chunked, got = saved_bytes(txlstm._slstm_scan, pre, w_h, 4, inputs=ins)
    zero = torch.zeros((B, di))
    one, _ = saved_bytes(txlstm._slstm_walk, pre[:, :w], zero, zero, w_h,
                          4, inputs=ins)
    assert torch.equal(got, want)
    assert abs(one - flat * w / s) < 0.1 * one, (one, flat)
    bound = one + (s // w) * 2 * B * di * 4
    assert flat > 3 * bound, (flat, bound)
    assert chunked < bound, (chunked, bound, flat)
    # and the backward, which recomputes each chunk, gives the flat
    # walk's gradients up to the order of float32 sums (0 seen here)
    ct = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    g_chunk = torch.autograd.grad((got * ct).sum(), [pre, w_h])
    g_flat = torch.autograd.grad((want * ct).sum(), [pre, w_h])
    for a, b in zip(g_chunk, g_flat):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('s,w', LENGTHS)
def test_no_grad_checkpoints_nothing(slstm, s, w, monkeypatch):
    """(d) ``layers.remat`` checkpoints each chunk while grad is on and
    there are several (none at S = 9, one chunk), and nothing under
    ``torch.no_grad()``."""
    _, cfg, p = slstm
    x, _ = _inputs(cfg, s)
    tp = _port_params(p)
    calls = []
    real = L.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(L, 'checkpoint', counted)
    with torch.no_grad():
        y_ng = txlstm.slstm_block(tp, t(x), cfg)
    assert calls == []
    y = txlstm.slstm_block(tp, t(x), cfg)
    assert calls == (['_slstm_walk'] * (s // w) if s > w else [])
    assert torch.equal(y, y_ng)
