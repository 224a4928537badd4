"""The port's LM training for the dense and vlm families against the JAX
package, on the CPU: the chunked cross entropy, ``train_loss`` and its
gradients (smollm-360m, chameleon-34b with qk-norm), remat against no
remat, and four steps of ``registry.make_train_step``.

``chunked_ce_loss`` agrees within 1e-6 relative on the same inputs, with
-1 labels, a ``loss_chunk`` that does not divide the sequence, a padded
vocab and both tied and untied embeddings.  Through a model the gradients
agree within ``torch_lm_train_parity.GRAD_TOL_FLASH`` of each leaf's
largest (the module docstring there says why).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import registry as jreg

from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as treg
from repro_torch.optim import adam as tadam
from torch_lm_train_parity import (check_loss_and_grads,
                                   check_remat_bit_for_bit,
                                   check_train_steps, train_family)
from torch_serve_parity import one_torch_thread  # noqa: F401

DENSE = ('smollm-360m', 'chameleon-34b')


def _ce_inputs(tie: bool, vp: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    d, b, s = 32, 2, 12
    p = {'embed': (rng.standard_normal((vp, d)) * 0.3).astype(np.float32),
         'final_norm': (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if not tie:
        p['unembed'] = (rng.standard_normal((d, vp)) * 0.3).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -1
    return p, x, labels


@pytest.mark.parametrize('tie,vp,vocab,chunk', [
    (False, 100, 100, 5),      # 12 % 5: the chunk shrinks to 4
    (True, 128, 100, 512),     # a padded vocab, one chunk of 12
    (False, 128, 120, 8)])     # 12 % 8: the chunk shrinks to 6
def test_chunked_ce_loss_matches_jax(tie, vp, vocab, chunk):
    cfg = dataclasses.replace(
        tconfigs.get_config('smollm-360m').reduced(), vocab=vocab,
        loss_chunk=chunk, tie_embeddings=tie)
    jcfg = dataclasses.replace(
        jconfigs.get_config('smollm-360m').reduced(), vocab=vocab,
        loss_chunk=chunk, tie_embeddings=tie)
    p, x, labels = _ce_inputs(tie, vp, vocab)
    ctx = jreg.make_ctx(None, jcfg)
    want, (wgp, wgx) = jax.value_and_grad(
        lambda p, x: jlayers.chunked_ce_loss(p, x, labels, jcfg, ctx),
        argnums=(0, 1))(p, x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    got = tlayers.chunked_ce_loss(tp, tx, torch.tensor(labels), cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    for g, w in [(tx.grad, wgx)] + [(tp[k].grad, wgp[k]) for k in p]:
        w = np.asarray(w)
        if g is None:             # untied: the loss never reads the embed
            assert not w.any()
            continue
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_chunked_ce_loss_counts_only_labelled_positions():
    """All labels -1: the loss is 0 over a count clamped to 1, as JAX's."""
    cfg = tconfigs.get_config('smollm-360m').reduced(vocab=100)
    p, x, labels = _ce_inputs(False, 100, 100)
    got = tlayers.chunked_ce_loss(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
        torch.full(labels.shape, -1, dtype=torch.int32), cfg)
    assert float(got) == 0.0


@pytest.mark.parametrize('arch', DENSE)
def test_train_loss_and_grads_match_jax(arch):
    gaps = check_loss_and_grads(train_family(arch))
    print(f'{arch}: worst leaf {max(gaps, key=gaps.get)} '
          f'{max(gaps.values()):.2e}')


@pytest.mark.parametrize('arch', DENSE)
def test_remat_is_bit_for_bit(arch):
    check_remat_bit_for_bit(arch)


def test_train_steps_match_jax():
    check_train_steps(train_family('smollm-360m'))


def test_train_step_updates_in_place_and_stays_on_the_device():
    """The step writes the model's parameters and the moments in place and
    returns device tensors: nothing is synced to the host."""
    cfg = tconfigs.get_config('smollm-360m').reduced()
    model = treg.init_params(0, cfg, device='cpu')
    step, acfg = treg.make_train_step(cfg, treg.make_ctx(None, cfg))
    assert acfg.state_dtype == torch.float32
    opt = tadam.init(list(model.parameters()), acfg)
    mu0 = opt.mu[0]
    before = [p.detach().clone() for p in model.parameters()]
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator()
                           .manual_seed(0))
    out, opt2, m = step(model, opt, {'tokens': tokens, 'labels': tokens})
    assert out is model and opt2.mu[0] is mu0 and int(opt2.step) == 1
    assert all(isinstance(v, torch.Tensor) and v.shape == ()
               for v in m.values())
    assert not m['loss'].requires_grad
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   model.parameters())]
    assert all(moved)
