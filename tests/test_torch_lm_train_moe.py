"""The port's LM training for the moe family against the JAX package, on
the CPU: granite-moe-1b-a400m (top-k softmax gate) and
llama4-maverick-400b-a17b (top-1 sigmoid gate, a shared expert, a dense
layer before each MoE layer).

``train_loss`` (the drop fraction is not part of it) and its gradients on
JAX's weights agree with JAX's (``torch_lm_train_parity``'s bounds); with
``remat`` the recomputed super-blocks route alike, so the loss and every
gradient equal those without, bit for bit; four steps of
``registry.make_train_step`` agree with JAX's jitted step.
"""
import pytest

from torch_lm_train_parity import (check_loss_and_grads,
                                   check_remat_bit_for_bit,
                                   check_train_steps, train_family)
from torch_serve_parity import one_torch_thread  # noqa: F401

MOE = ('granite-moe-1b-a400m', 'llama4-maverick-400b-a17b')


@pytest.mark.parametrize('arch', MOE)
def test_train_loss_and_grads_match_jax(arch):
    gaps = check_loss_and_grads(train_family(arch))
    print(f'{arch}: worst leaf {max(gaps, key=gaps.get)} '
          f'{max(gaps.values()):.2e}')


@pytest.mark.parametrize('arch', MOE)
def test_remat_is_bit_for_bit(arch):
    check_remat_bit_for_bit(arch)


def test_train_steps_match_jax():
    check_train_steps(train_family('granite-moe-1b-a400m'))
