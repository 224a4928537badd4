"""The port's mixture-of-experts family (``repro_torch.models.moe``)
against the JAX package's, on the CPU.

The routing and the dispatch plan are integers and are held exactly: the
top-k expert ids, and over the stably sorted assignments each one's keep
flag and bucket row, with the dropped fraction, once with ample capacity
and once with a capacity that drops.  The combined output agrees within
1e-5 and equals the brute-force per-token expert sum of
``tests/test_models.py::test_moe_dispatch_exact_vs_dense``.  For granite
(top-8 softmax gate, reduced to top-2) and maverick (top-1 sigmoid gate, a
shared expert, a dense layer before each MoE layer): the weights carry
over exactly, and forward, prefill and 12 decode steps agree with JAX's
(``torch_lm_parity.FLIP_TOL``), and decode agrees with forward on the
port's own weights within JAX's 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import registry as jreg

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from torch_lm_parity import (assert_close, check_decode_matches_forward,
                             check_family_matches_jax, family, jax_sizes,
                             leaf_of, t)
from torch_serve_parity import one_torch_thread  # noqa: F401


def _jax_plan(top_idx, cap: int, e: int) -> dict:
    """The dispatch plan as ``src/repro/models/moe.py:74-82`` computes it
    inside ``_dispatch_compute_combine``."""
    n, k = top_idx.shape
    flat_e = top_idx.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    starts = jnp.searchsorted(se, jnp.arange(e, dtype=jnp.int32), side='left')
    rank = jnp.arange(n * k, dtype=jnp.int32) - starts[se]
    keep = rank < cap
    slot = jnp.where(keep, se * cap + rank, e * cap)
    return {'order': order, 'st': st, 'rank': rank, 'keep': keep,
            'slot': slot}


@pytest.mark.parametrize('arch,n_tokens,capacity_factor,drops', [
    ('granite-moe-1b-a400m', 16, 1.25, False),
    # 512 tokens x top-2 over 4 experts at factor 0.25: capacity 128 of
    # about 256 assignments an expert
    ('granite-moe-1b-a400m', 512, 0.25, True),
    # top-1 of 4 experts: about 200 assignments an expert, capacity 128
    ('llama4-maverick-400b-a17b', 800, 0.5, True),
    # no drop: XLA's 1 - mean(keep) over 300 is -2.4e-8
    ('llama4-maverick-400b-a17b', 300, 1.0, False)])
def test_routing_and_dispatch_match_jax(arch, n_tokens, capacity_factor,
                                        drops):
    jcfg = jconfigs.get_config(arch).reduced(capacity_factor=capacity_factor)
    cfg = tconfigs.get_config(arch).reduced(capacity_factor=capacity_factor)
    ctx = jreg.make_ctx(None, jcfg)
    p = jmoe.moe_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = jax.tree.map(t, p)
    x = np.random.default_rng(2).standard_normal(
        (2, n_tokens // 2, cfg.d_model)).astype(np.float32)
    xf = x.reshape(n_tokens, -1)
    cap = tmoe.moe_capacity(cfg, n_tokens)
    assert cap == jmoe.moe_capacity(jcfg, n_tokens) and cap % 128 == 0

    weights, top_idx = jmoe._route(p['router'], xf, jcfg.top_k)
    tweights, ttop_idx = tmoe._route(tp['router'], t(xf), cfg.top_k)
    np.testing.assert_array_equal(ttop_idx.numpy(), np.asarray(top_idx))
    assert_close(tweights, weights)
    plan = _jax_plan(top_idx, cap, cfg.n_experts)
    tplan = tmoe.dispatch(ttop_idx, cap, cfg.n_experts)
    for key, want in plan.items():
        np.testing.assert_array_equal(tplan[key].numpy(), np.asarray(want),
                                      err_msg=key)

    out, drop = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg, ctx))(p, x)
    tout, tdrop = tmoe.moe_ffn(tp, t(x), cfg)
    assert float(tdrop) == float(drop)
    assert (float(drop) > 0.1) == drops
    assert_close(tout, out)
    if drops and not cfg.shared_expert:
        # a token whose every assignment dropped gets zeros
        kept = np.zeros(n_tokens, bool)
        kept[np.asarray(plan['st'])[np.asarray(plan['keep'])]] = True
        assert (~kept).any()
        assert not tout.reshape(n_tokens, -1)[torch.from_numpy(~kept)].any()


def test_dispatch_equals_brute_force_expert_sum():
    """With ample capacity, the sort-based dispatch equals every token
    through its top-k experts, weighted and summed (the JAX test's
    property and tolerance)."""
    cfg = tconfigs.get_config('granite-moe-1b-a400m').reduced(
        n_experts=4, top_k=2, capacity_factor=8.0)
    p = tmoe.moe_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    out, drop = tmoe.moe_ffn(p, x, cfg)
    assert float(drop) == 0.0
    xf = x.reshape(-1, cfg.d_model)
    weights, top_idx = tmoe._route(p['router'], xf, cfg.top_k)
    want = torch.zeros_like(xf)
    for i in range(xf.shape[0]):
        for j in range(cfg.top_k):
            e = int(top_idx[i, j])
            y = tmoe._expert_ffn(xf[i][None, None], p['w_up'][e][None],
                                 p['w_gate'][e][None], p['w_down'][e][None],
                                 cfg)[0, 0]
            want[i] += weights[i, j] * y
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               want.numpy(), atol=1e-4, rtol=1e-3)


@pytest.fixture(scope='module', params=['granite-moe-1b-a400m',
                                        'llama4-maverick-400b-a17b'])
def moe_family(request):
    return family(request.param)


def test_interop_weights_are_exact(moe_family):
    model, params = moe_family['model'], moe_family['params']
    n = 0
    for name, leaf in model.named_parameters():
        want = leaf_of(params, name)
        assert str(leaf.dtype).split('.')[-1] == want.dtype.name, name
        np.testing.assert_array_equal(leaf.detach().numpy(), want)
        n += leaf.numel()
    assert n == jax_sizes(params)
    assert model.blocks[0].moe.router.dtype == torch.float32
    assert ('shared' in model.blocks[0].moe) == \
        (moe_family['arch'] == 'llama4-maverick-400b-a17b')


def test_forward_prefill_decode_match_jax(moe_family):
    check_family_matches_jax(moe_family)


@pytest.mark.parametrize('arch', ['granite-moe-1b-a400m',
                                  'llama4-maverick-400b-a17b'])
def test_decode_matches_forward_on_the_port(arch):
    check_decode_matches_forward(arch)
