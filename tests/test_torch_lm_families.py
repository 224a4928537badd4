"""The port's whisper, xlstm and zamba2 families, and the weights and
decode states of every family carried across, against the JAX package,
on the CPU.

For each reduced config: the JAX weights land in the port bit for bit;
forward, prefill and 12 decode steps (logits and the final state) agree
with JAX's (xlstm within 1e-5, the families with attention within
``torch_lm_parity.FLIP_TOL``); decode agrees with forward on the port's own
weights within JAX's 2e-2 (whisper: ``decode_step`` over ``prepare_cross``
against ``decode_train``).  Whisper's cross attention, its k/v and
``prepare_cross`` agree within 1e-5 on the same inputs.  Every family's
parameter shapes and dtypes equal JAX's at tp 1 and 2, and every family's
decode state carries over exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro.models import whisper as jwhisper

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as treg
from torch_lm_parity import (FAMILIES, assert_close,
                             check_decode_matches_forward,
                             check_family_matches_jax, family, jax_sizes,
                             leaf_of, split_name, t)
from torch_serve_parity import one_torch_thread  # noqa: F401

RECURRENT = ('whisper-base', 'xlstm-1.3b', 'zamba2-1.2b')
# 15 q / 5 kv heads and a vocab off the TP multiple, so that tp 2 pads both
ODD = dict(n_heads=15, n_kv_heads=5, d_model=120, head_dim=8, vocab=500)


@pytest.fixture(scope='module', params=RECURRENT)
def fam(request):
    return family(request.param)


def test_interop_weights_are_exact(fam):
    model, params = fam['model'], fam['params']
    n = 0
    for name, leaf in model.named_parameters():
        want = leaf_of(params, name)
        assert str(leaf.dtype).split('.')[-1] == want.dtype.name, name
        np.testing.assert_array_equal(leaf.detach().numpy(), want)
        n += leaf.numel()
    assert n == jax_sizes(params)


def test_forward_prefill_decode_match_jax(fam):
    check_family_matches_jax(fam)


@pytest.mark.parametrize('arch', RECURRENT)
def test_decode_matches_forward_on_the_port(arch):
    check_decode_matches_forward(arch)


def test_whisper_cross_attention_matches_jax():
    """``cross_kv``, ``attention_cross`` (flash attention, not causal, with
    its bfloat16 roundings) and ``prepare_cross`` on the same inputs."""
    fam = family('whisper-base')
    jcfg, cfg, model = fam['jcfg'], fam['cfg'], fam['model']
    ctx = jreg.make_ctx(None, jcfg)
    p = jax.tree.map(lambda a: a[1], fam['params']['dec'])['cross']
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    kv = jlayers.cross_kv(p, enc, jcfg, ctx)
    tkv = tlayers.cross_kv(model.dec[1].cross, t(enc), cfg)
    for g, w in zip(tkv, kv):
        assert_close(g, w)
    assert_close(tlayers.attention_cross(model.dec[1].cross, t(x), cfg,
                                         tuple(t(a) for a in kv)),
                 jlayers.attention_cross(p, x, jcfg, ctx, kv))
    frames = fam['data']['frames']
    cross = jwhisper.prepare_cross(fam['params'], frames, jcfg, ctx)
    tcross = model.prepare_cross(t(frames))
    assert tuple(tcross[0].shape) == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                      cfg.resolved_head_dim())
    for g, w in zip(tcross, cross):
        assert_close(g, w)


@pytest.mark.parametrize('tp', [1, 2])
@pytest.mark.parametrize('arch', FAMILIES)
def test_param_shapes_match_jax(arch, tp):
    """At tp 2, 15 q heads pad to 16 and a 500 vocab to 512; every
    parameter's shape and dtype equal JAX's (less the unstacked axes), and
    the port's parameters cover JAX's exactly."""
    jcfg = jconfigs.get_config(arch).reduced(**ODD)
    cfg = tconfigs.get_config(arch).reduced(**ODD)
    abstract = jreg.abstract_params(jcfg, tp=tp)
    model = treg.init_params(0, cfg, tp=tp, device='cpu')
    n = 0
    for name, leaf in model.named_parameters():
        keys, idx = split_name(name)
        want = abstract
        for key in keys:
            want = want[key]
        assert (tuple(leaf.shape), str(leaf.dtype).split('.')[-1]) == \
            (want.shape[len(idx):], want.dtype.name), name
        n += leaf.numel()
    assert n == jax_sizes(abstract)
    assert model.tok['embed'].shape[0] == (512 if tp == 2 else 500)


@pytest.mark.parametrize('arch', FAMILIES + ('smollm-360m',))
def test_decode_state_from_numpy_is_exact(arch):
    """A JAX decode state, filled with seeded values, carries over leaf for
    leaf with its dtypes, in the tree of the port's ``init_decode_state``."""
    jcfg = jconfigs.get_config(arch).reduced(dtype='bfloat16')
    cfg = tconfigs.get_config(arch).reduced(dtype='bfloat16')
    state = jreg.init_decode_state(jcfg, 3, 8)
    rng = np.random.default_rng(0)
    state = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape),
                                         a.dtype)), state)
    got = interop.decode_state_from_numpy(state, cfg, device='cpu')
    fresh = treg.init_decode_state(cfg, 3, 8, device='cpu')
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(fresh)
    for g, f, w in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(fresh),
                       jax.tree_util.tree_leaves(state)):
        assert g.dtype == f.dtype and g.shape == f.shape
        assert str(g.dtype).split('.')[-1] == w.dtype.name
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32))
    with pytest.raises(ValueError, match=arch):
        interop.decode_state_from_numpy(
            list(state.values()) if isinstance(state, dict)
            else dict(enumerate(state)), cfg, device='cpu')
