"""The port's learning-rate schedules, int8 gradient compression and
AdamW's ``lr_scale`` against the JAX package, on the CPU.

Schedules agree within one float32 ulp at every step that changes a
branch (0, 1, the warmup's edges, the middle, the end and past it), from
an int and from a 0-d tensor.  Compression's int8 payloads and residuals
are equal exactly and its scales within one ulp, on seeded arrays of 1,
255, 256, 257 and 1000 elements, an all-zero block and a bfloat16 leaf,
alone and as trees, with and without a residual.  JAX's error-feedback
test and its compressed toy training step
(``tests/test_optim_data.py``, ``tests/test_integration.py``) hold on the
port.  ``adam.step`` with a tensor ``lr_scale`` agrees with JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched

from repro_torch.optim import adam as tadam
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedule as tsched
from torch_serve_parity import one_torch_thread  # noqa: F401

WARMUP, TOTAL = 10, 100
STEPS = (0, 1, WARMUP - 1, WARMUP, WARMUP + 1, (WARMUP + TOTAL) // 2,
         TOTAL - 1, TOTAL, TOTAL + 7, 1000)
SCHEDULES = {
    'warmup_cosine': dict(warmup_steps=WARMUP, total_steps=TOTAL),
    'warmup_cosine_min0': dict(warmup_steps=WARMUP, total_steps=TOTAL,
                               min_ratio=0.0),
    'cosine_no_warmup': dict(warmup_steps=0, total_steps=TOTAL),
    'constant': dict(value=0.37),
    'exponential': dict(decay_steps=30, rate=0.5),
    'exponential_staircase': dict(decay_steps=30, rate=0.7, staircase=True),
}


def _fn(mod, name):
    return getattr(mod, {'constant': 'constant',
                         'exponential': 'exponential_decay',
                         'exponential_staircase': 'exponential_decay'}
                   .get(name, 'linear_warmup_cosine'))


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_schedule_matches_jax(name):
    kw = SCHEDULES[name]
    want = np.asarray([_fn(jsched, name)(s, **kw) for s in STEPS],
                      np.float32)
    for as_tensor in (False, True):
        got = []
        for s in STEPS:
            out = _fn(tsched, name)(
                torch.tensor(s, dtype=torch.int32) if as_tensor else s, **kw)
            assert out.dtype == torch.float32 and out.shape == ()
            got.append(float(out))
        np.testing.assert_array_max_ulp(np.asarray(got, np.float32), want,
                                        maxulp=1)


def test_warmup_reads_zero_at_the_first_step():
    """The trainer reads the scale at the step count before its increment:
    with a warmup the first update is at scale 0, as in the JAX package."""
    assert float(tsched.linear_warmup_cosine(
        torch.zeros((), dtype=torch.int32), warmup_steps=2,
        total_steps=8)) == 0.0


# -- compression -------------------------------------------------------------

def _array(n: int, seed: int, dtype=np.float32) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 3.0).astype(
        dtype)


def _check_compressed(got: tcomp.Compressed, want: jcomp.Compressed):
    assert got.shape == tuple(want.shape) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_max_ulp(got.scale.numpy(),
                                    np.asarray(want.scale), maxulp=1)


CASES = {f'n{n}': _array(n, n) for n in (1, 255, 256, 257, 1000)}
CASES['zero_block'] = np.concatenate([np.zeros(256, np.float32),
                                      _array(40, 7)])
CASES['matrix'] = _array(300, 3).reshape(20, 15)


@pytest.mark.parametrize('case', list(CASES))
def test_compress_matches_jax(case):
    x = CASES[case]
    residual = _array(x.size, 11).reshape(x.shape) * 0.01
    for r in (None, residual):
        want, want_res = jcomp.compress(
            jnp.asarray(x), None if r is None else jnp.asarray(r))
        got, got_res = tcomp.compress(
            torch.tensor(x), None if r is None else torch.tensor(r))
        _check_compressed(got, want)
        assert got_res.dtype == torch.float32
        np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))
        np.testing.assert_array_equal(tcomp.decompress(got).numpy(),
                                      np.asarray(jcomp.decompress(want)))
    if case == 'zero_block':   # no residual: the first block is all zero
        got, _ = tcomp.compress(torch.tensor(x))
        assert float(got.scale[0]) == float(np.float32(1e-12))
        assert not got.q[0].any()


def test_compress_tree_matches_jax():
    """A dict of a list, a tuple and a bfloat16 leaf, with residuals."""
    bf = _array(500, 5).astype(np.float32)
    jtree = {'b': [jnp.asarray(CASES['n257']), jnp.asarray(CASES['matrix'])],
             'a': (jnp.asarray(CASES['n1']),),
             'w': jnp.asarray(bf, jnp.bfloat16)}
    ttree = {'b': [torch.tensor(CASES['n257']), torch.tensor(CASES['matrix'])],
             'a': (torch.tensor(CASES['n1']),),
             'w': torch.tensor(bf).to(torch.bfloat16)}
    np.testing.assert_array_equal(
        ttree['w'].float().numpy(), np.asarray(jtree['w'], np.float32))
    jres = jcomp.init_residuals(jtree)
    tres = tcomp.init_residuals(ttree)
    for _ in range(2):     # the second round feeds the first's residuals
        jc, jres = jcomp.compress_tree(jtree, jres)
        tc, tres = tcomp.compress_tree(ttree, tres)
        for got, want in ((tc['b'][0], jc['b'][0]), (tc['b'][1], jc['b'][1]),
                          (tc['a'][0], jc['a'][0]), (tc['w'], jc['w'])):
            _check_compressed(got, want)
        for got, want in ((tres['b'][0], jres['b'][0]),
                          (tres['a'][0], jres['a'][0]),
                          (tres['w'], jres['w'])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert isinstance(tc['a'], tuple) and isinstance(tc['b'], list)
        jd, td = jcomp.decompress_tree(jc), tcomp.decompress_tree(tc)
        np.testing.assert_array_equal(td['b'][1].numpy(),
                                      np.asarray(jd['b'][1]))
        assert td['w'].dtype == torch.float32 and td['w'].shape == (500,)


def test_compression_error_feedback_converges():
    """``tests/test_optim_data.py``'s property on the port: the time
    average of the dequantized values converges to the true ones."""
    x = torch.tensor([0.001, -0.002, 3.0, 0.0005])
    residual = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    steps = 50
    for _ in range(steps):
        comp, residual = tcomp.compress(x, residual)
        acc = acc + tcomp.decompress(comp)
    scale = 3.0 / 127.0
    np.testing.assert_allclose((acc / steps).numpy(), x.numpy(),
                               atol=2 * scale / steps)


def test_grad_compression_in_training_step():
    """``tests/test_integration.py``'s property on the port: int8
    error-feedback compression keeps a toy least-squares model training
    (seeded numpy data in place of JAX's keys)."""
    rng = np.random.default_rng(0)
    w = [torch.tensor(rng.standard_normal((16, 16)).astype(np.float32)
                      * 0.1, requires_grad=True)]
    x = torch.tensor(rng.standard_normal((32, 16)).astype(np.float32))
    y = x @ torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))
    cfg = tadam.AdamConfig(lr=1e-2)
    state = tadam.init(w, cfg)
    residual = tcomp.init_residuals(w)
    losses = []
    for _ in range(60):
        loss = torch.mean((x @ w[0] - y) ** 2)
        g = torch.autograd.grad(loss, w)
        comp, residual = tcomp.compress_tree(list(g), residual)
        w, state, _ = tadam.step(w, tcomp.decompress_tree(comp), state, cfg)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])


# -- adam's lr_scale -----------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_adam_lr_scale_matches_jax(dtype):
    """Three steps at the warmup-cosine scale of steps 0, 1 and 2 (a
    device tensor, read before the increment as the trainer reads it)."""
    bf16 = dtype == 'bfloat16'
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    p = _array(40, 1) * 0.1
    g = _array(40, 2)
    jcfg = jadam.AdamConfig(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    tcfg = tadam.AdamConfig(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    jp, jg = {'w': jnp.asarray(p, jdt)}, {'w': jnp.asarray(g, jdt)}
    tp, tg = [torch.tensor(p).to(tdt)], [torch.tensor(g).to(tdt)]
    jstate, tstate = jadam.init(jp, jcfg), tadam.init(tp, tcfg)
    kw = dict(warmup_steps=2, total_steps=6)
    for i in range(3):
        jscale = jsched.linear_warmup_cosine(jstate.step, **kw)
        tscale = tsched.linear_warmup_cosine(tstate.step, **kw)
        jp, jstate, jnorm = jadam.step(jp, jg, jstate, jcfg, lr_scale=jscale)
        tp, tstate, tnorm = tadam.step(tp, tg, tstate, tcfg, lr_scale=tscale)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        np.testing.assert_allclose(tp[0].float().numpy(),
                                   np.asarray(jp['w'], np.float32),
                                   rtol=1e-5, atol=1e-7)
        for got, want in ((tstate.mu[0], jstate.mu['w']),
                          (tstate.nu[0], jstate.nu['w'])):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-5, atol=1e-12)
        if i == 0:         # scale 0 at step 0: weight decay and all, no move
            assert torch.equal(tp[0], torch.tensor(p).to(tdt))
    assert int(tstate.step) == 3


def test_adam_step_writes_the_moments_in_place():
    """The step returns the moments it was given, updated: no second copy
    of the optimizer state exists during a step."""
    cfg = tadam.AdamConfig()
    p = [torch.ones(4), torch.ones(3, 2)]
    state = tadam.init(p, cfg)
    ids = [id(t) for t in state.mu + state.nu]
    _, new, _ = tadam.step(p, [torch.ones(4), torch.ones(3, 2)], state, cfg)
    assert [id(t) for t in new.mu + new.nu] == ids
    assert int(new.step) == 1 and bool((new.mu[0] != 0).all())
