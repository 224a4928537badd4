"""The port's LM layers (``repro_torch.models.layers``), padding helpers
(``runtime.sharding``) and synthetic tokens (``data.tokens``) against the
JAX package's, on the CPU.

Inputs are numpy arrays from a seeded generator, fed to both packages.
Tolerances:

* float32: 2e-6 absolute + 2e-6 relative (ulp-level: the same float32
  arithmetic, summed in another order);
* ``flash_attention`` rounds Q x scale, K, P and V to bfloat16 in both
  packages and sums in float32: 1e-5 (a bfloat16 rounding that flips on a
  float32 ulp of its input moves a score by 2^-8 of itself, rarely);
* bfloat16 inputs: 2 bfloat16 ulps of the magnitude (2^-7 relative), the
  outputs being bfloat16 roundings of float32 values that may fall on
  either side of a rounding boundary;
* tokens: exactly equal.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jtok
from repro.models import layers as jL
from repro.runtime import sharding as jsh

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import tokens as ttok
from repro_torch.models import layers as tL
from repro_torch.runtime import sharding as tsh
from torch_serve_parity import one_torch_thread  # noqa: F401

F32_TOL = dict(atol=2e-6, rtol=2e-6)
BF16_REL = 2 * 2.0 ** -7
DTYPES = ('float32', 'bfloat16')
CTX = jsh.ShardCtx(mesh=None)
# JAX's functions jitted (one compile each, not one per operation)
_TOKENS = dict(static_argnums=(0, 1, 2, 3, 4),
               static_argnames=('batch_offset',))
jax_tokens = jax.jit(jtok.synthetic_tokens, **_TOKENS)
jax_batch = jax.jit(jtok.synthetic_batch, **_TOKENS)
# seed, step and batch offset traced: one compile a batch shape
jax_host_batch = jax.jit(jtok.synthetic_batch, static_argnums=(2, 3, 4))


def jit(fn, **consts):
    """``fn`` jitted with the keyword arguments ``consts`` held fixed."""
    return jax.jit(functools.partial(fn, **consts))


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(x, dtype):
    """The numpy array ``x`` as a JAX array and a torch tensor of ``dtype``
    with identical values."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.dtype(dtype))
    return j, interop.tensor(np.asarray(j), device='cpu')


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dtype, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == 'bfloat16':
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, atol=BF16_REL * scale, rtol=0)
    else:
        np.testing.assert_allclose(got, want, **tol)


def _cfg(arch='smollm-360m', **kw):
    """The reduced config in both packages, with the same overrides."""
    return (jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw))


def _params(tree, dtype):
    """A dict of numpy arrays as JAX and torch dicts of ``dtype``."""
    jp, tp = {}, {}
    for k, v in tree.items():
        jp[k], tp[k] = _pair(v, dtype)
    return jp, tp


# --- basics ----------------------------------------------------------------

@pytest.mark.parametrize('dtype', DTYPES)
def test_rmsnorm(dtype):
    r = _rng(0)
    (jx, tx), (jw, tw) = (_pair(r.normal(size=(2, 5, 48)), dtype),
                          _pair(1 + 0.1 * r.normal(size=(48,)), dtype))
    got, want = tL.rmsnorm(tx, tw, 1e-5), jit(jL.rmsnorm, eps=1e-5)(jx, jw)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_rope(dtype):
    r = _rng(1)
    jx, tx = _pair(r.normal(size=(2, 7, 3, 16)), dtype)
    pos = r.integers(0, 300, size=(2, 7)).astype(np.int32)
    got = tL.rope(tx, torch.from_numpy(pos), 10000.0)
    want = jit(jL.rope, theta=10000.0)(jx, jnp.asarray(pos))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))


def test_dense_init_distribution():
    """Normal with std ``scale``, cast to the dtype, on the generator's
    device; ``wo`` and ``w_down`` at 0.02 / sqrt(2 L)."""
    _, cfg = _cfg(d_model=64, n_layers=8)
    gen = torch.Generator().manual_seed(0)
    w = tL.dense_init(gen, 256, 512, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) - 0.02) < 0.02 * 0.02
    assert abs(float(w.float().mean())) < 1e-3 * 0.02 * 10
    p = tL.attention_params(gen, cfg, torch.float32, tp=1)
    want = 0.02 / math.sqrt(2 * cfg.n_layers)
    assert abs(float(p['wo'].std()) - want) < 0.05 * want
    assert abs(float(tL.mlp_params(gen, cfg, torch.float32)['w_down'].std())
               - want) < 0.05 * want


# --- padding ---------------------------------------------------------------

@pytest.mark.parametrize('tp', [1, 2, 3, 4, 8, 16])
def test_padding_helpers(tp):
    for n in (1, 4, 5, 8, 15, 40, 56, 64):
        assert tsh.padded_heads(n, tp) == jsh.padded_heads(n, tp)
        assert tsh.replicated_kv_heads(n, tp) == jsh.replicated_kv_heads(n, tp)
        assert tsh.pad_to_multiple(n, tp) == jsh.pad_to_multiple(n, tp)
    for arch in ('smollm-360m', 'yi-34b', 'command-r-35b'):
        jc, tc = jax_get_config(arch), get_config(arch)
        assert tL.padded_vocab(tc, tp) == jL.padded_vocab(jc, tp)


def test_repeat_kv_grouping():
    """smollm's 15 q / 5 kv heads padded to 16: head i reads kv i // 3,
    the padded head the last kv head."""
    r = _rng(2)
    k = r.normal(size=(2, 3, 5, 4)).astype(np.float32)
    got = tL.repeat_kv(torch.from_numpy(k), 16, n_heads=15)
    want = jL.repeat_kv(jnp.asarray(k), 16, n_heads=15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = tL.repeat_kv(torch.arange(5.0)[None, None, :, None], 16, 15)
    assert idx[0, 0, :, 0].long().tolist() == [i // 3 for i in range(15)] + [4]


# --- attention -------------------------------------------------------------

FLASH_CASES = [
    # (s, t, q_chunk, kv_chunk, causal, q_offset, dtype)
    (16, 16, 8, 8, True, 0, 'float32'),
    (16, 16, 8, 8, False, 0, 'float32'),
    (12, 20, 8, 16, True, 0, 'float32'),     # chunks shrink to 6 and 10
    (7, 13, 4, 5, False, 0, 'float32'),      # primes: chunks of 1
    (6, 18, 4, 8, True, 12, 'float32'),      # a decode window at 12
    (10, 24, 4, 7, True, 14, 'float32'),
    (16, 16, 512, 1024, True, 0, 'bfloat16'),
    (12, 20, 8, 16, True, 8, 'bfloat16'),
]


@pytest.mark.parametrize('s,t,qc,kc,causal,q_offset,dtype', FLASH_CASES)
def test_flash_attention(s, t, qc, kc, causal, q_offset, dtype):
    r = _rng(3)
    h, hd = 3, 16
    jq, tq = _pair(r.normal(size=(2, s, h, hd)), dtype)
    jk, tk = _pair(r.normal(size=(2, t, h, hd)), dtype)
    jv, tv = _pair(r.normal(size=(2, t, h, hd)), dtype)
    got = tL.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                             q_chunk=qc, kv_chunk=kc)
    want = jit(jL.flash_attention, causal=causal, q_offset=q_offset,
               q_chunk=qc, kv_chunk=kc)(jq, jk, jv)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))


def _attn_inputs(cfg, dtype, tp, seed, s=6):
    r = _rng(seed)
    gen = torch.Generator().manual_seed(seed)
    # draw the weights in float32, then cast in both packages; a larger
    # scale than the init's makes the scores matter
    tree = {k: 4 * v.float().numpy() if k[0] == 'w' else
            (1 + 0.1 * r.normal(size=v.shape)).astype(np.float32)
            for k, v in tL.attention_params(gen, cfg, torch.float32,
                                            tp).items()}
    jp, tp_ = _params(tree, dtype)
    jx, tx = _pair(r.normal(size=(2, s, cfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s))
    return jp, tp_, jx, tx, pos


ATTN_CASES = [('smollm-360m', 'float32', 1), ('smollm-360m', 'float32', 2),
              ('chameleon-34b', 'float32', 1), ('chameleon-34b', 'float32', 2),
              ('smollm-360m', 'bfloat16', 2)]
# 15 q / 5 kv heads, as smollm's: at tp 2 the q heads pad to 16
ODD_HEADS = dict(n_heads=15, n_kv_heads=5, d_model=120, head_dim=8)


@pytest.mark.parametrize('arch,dtype,tp', ATTN_CASES)
def test_attention_train_and_prefill(arch, dtype, tp):
    jc, tc = _cfg(arch, **ODD_HEADS)
    jp, tp_, jx, tx, pos = _attn_inputs(tc, dtype, tp, seed=4)
    assert tp_['wq'].shape[1] // 8 == tsh.padded_heads(15, tp)
    tpos = torch.from_numpy(pos.copy())
    for causal in (True, False):
        got = tL.attention_train(tp_, tx, tc, tpos, causal)
        want = jit(jL.attention_train, cfg=jc, ctx=CTX, causal=causal)(
            jp, jx, positions=jnp.asarray(pos))
        assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))
    got, (gk, gv) = tL.attention_prefill(tp_, tx, tc, tpos)
    want, (wk, wv) = jit(jL.attention_prefill, cfg=jc, ctx=CTX)(
        jp, jx, positions=jnp.asarray(pos))
    assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))
    assert_close(gk, wk, dtype)
    assert_close(gv, wv, dtype)


@pytest.mark.parametrize('arch,dtype,tp', ATTN_CASES)
def test_attention_decode(arch, dtype, tp):
    """The step writes K/V at ``pos`` in every row, in place, and attends
    positions <= ``pos``; also at a ``pos`` past the cache (clamped)."""
    jc, tc = _cfg(arch, **ODD_HEADS)
    jp, tp_, jx, tx, _ = _attn_inputs(tc, dtype, tp, seed=5, s=1)
    r = _rng(6)
    t = 9
    cache = [r.normal(size=(2, t, 5, 8)) for _ in range(2)]
    step = jit(jL.attention_decode, cfg=jc, ctx=CTX)
    for pos in (0, 4, t - 1, t + 2):
        jcache = tuple(_pair(c, dtype)[0] for c in cache)
        tcache = tuple(_pair(c, dtype)[1] for c in cache)
        got, (gk, gv) = tL.attention_decode(tp_, tx, tc, tcache, pos)
        want, (wk, wv) = step(jp, jx, cache=jcache, pos=jnp.int32(pos))
        assert gk is tcache[0] and gv is tcache[1]       # in place
        assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))
        assert_close(gk, wk, dtype)
        assert_close(gv, wv, dtype)


# --- mlp, embedding, logits --------------------------------------------------

@pytest.mark.parametrize('act', ['swiglu', 'relu2', 'gelu'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_mlp(act, dtype):
    jc, tc = _cfg(act=act, d_model=48, d_ff=96)
    gen = torch.Generator().manual_seed(7)
    tree = {k: 10 * v.numpy() for k, v in
            tL.mlp_params(gen, tc, torch.float32).items()}
    assert ('w_gate' in tree) == (act == 'swiglu')
    jp, tp_ = _params(tree, dtype)
    jx, tx = _pair(_rng(8).normal(size=(2, 5, 48)), dtype)
    got = tL.mlp(tp_, tx, tc)
    want = jit(jL.mlp, cfg=jc, ctx=CTX)(jp, jx)
    assert_close(got, want, dtype, tol=dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize('tie', [False, True])
@pytest.mark.parametrize('dtype,tp', [('float32', 1), ('float32', 2),
                                      ('bfloat16', 2)])
def test_embed_and_logits(tie, dtype, tp):
    """The vocab pads to the TP multiple (500 -> 512 at tp 2) and the pad
    logits are masked to -1e30."""
    jc, tc = _cfg(vocab=500, d_model=48, tie_embeddings=tie)
    gen = torch.Generator().manual_seed(9)
    tree = {k: v.numpy() for k, v in
            tL.embed_params(gen, tc, torch.float32, tp).items()}
    assert tree['embed'].shape == (tL.padded_vocab(tc, tp), 48)
    assert ('unembed' in tree) != tie
    jp, tp_ = _params(tree, dtype)
    toks = _rng(10).integers(0, 500, size=(2, 5)).astype(np.int32)
    ge = tL.embed(tp_, torch.from_numpy(toks))
    we = jit(jL.embed, ctx=CTX)(jp, jnp.asarray(toks))
    np.testing.assert_array_equal(_np(ge), _np(we))
    got, want = tL.logits(tp_, ge, tc), jit(jL.logits, cfg=jc, ctx=CTX)(jp, we)
    assert_close(got, want, dtype)


# --- tokens ------------------------------------------------------------------

@pytest.mark.parametrize('seed,step,batch,seq,vocab,offset', [
    (1, 5, 4, 16, 997, 0), (1, 6, 4, 16, 997, 0), (0, 0, 2, 9, 53, 0),
    (7, 3, 1, 4, 512, 0), (3, 2 ** 31 + 11, 3, 40, 49152, 5),
    (2 ** 32 - 1, 7, 2, 8, 256000, 2 ** 20)])
def test_synthetic_tokens_exact(seed, step, batch, seq, vocab, offset):
    got = ttok.synthetic_tokens(seed, step, batch, seq, vocab,
                                batch_offset=offset, device='cpu')
    want = jax_tokens(seed, step, batch, seq, vocab, batch_offset=offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < vocab


def test_synthetic_batch_labels_are_shifted_tokens():
    got = ttok.synthetic_batch(0, 0, 2, 8, 53, device='cpu')
    want = jax_batch(0, 0, 2, 8, 53, batch_offset=0)
    for k in ('tokens', 'labels'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    full = ttok.synthetic_tokens(0, 0, 2, 9, 53, device='cpu')
    assert torch.equal(got['labels'], full[:, 1:])


@pytest.mark.parametrize('num_hosts', [1, 2, 4, 8, 16])
@pytest.mark.parametrize('step0', [0, 3])
def test_token_stream_host_sharding(num_hosts, step0):
    """Every host's slice, concatenated, is the single-host global batch,
    and equals the JAX package's slice (what its ``TokenStream.next``
    computes: ``synthetic_batch`` at the host's batch offset)."""
    gb, seq, vocab = 16, 8, 211
    slices = []
    for h in range(num_hosts):
        s = ttok.TokenStream(seed=3, global_batch=gb, seq=seq, vocab=vocab,
                             host_id=h, num_hosts=num_hosts, step=step0,
                             device='cpu')
        got = s.next()['tokens']
        want = jax_host_batch(3, step0, s.local_batch, seq, vocab,
                              batch_offset=h * s.local_batch)['tokens']
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        slices.append(got)
    view = ttok.global_batch_view(3, step0, gb, seq, vocab, device='cpu')
    assert torch.equal(torch.cat(slices), view['tokens'])
    assert s.step == step0 + 1


def test_token_stream_resume():
    s1 = ttok.TokenStream(seed=0, global_batch=4, seq=8, vocab=101,
                          device='cpu')
    for _ in range(3):
        s1.next()
    state = s1.state_dict()
    want = s1.next()
    s2 = ttok.TokenStream(seed=0, global_batch=4, seq=8, vocab=101,
                          device='cpu')
    s2.load_state_dict(state)
    got = next(s2)
    assert torch.equal(got['tokens'], want['tokens'])
    assert state == {'step': 3, 'seed': 0}
    np.testing.assert_array_equal(
        got['tokens'].numpy(),
        np.asarray(jax_host_batch(0, 3, 4, 8, 101, batch_offset=0)['tokens']))
    with pytest.raises(ValueError, match='seed'):
        s2.load_state_dict({'step': 0, 'seed': 1})
    with pytest.raises(ValueError):
        ttok.TokenStream(seed=0, global_batch=6, seq=8, vocab=101,
                         num_hosts=4, device='cpu')
