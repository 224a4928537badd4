"""The port's LM training for the hybrid family against the JAX package,
on the CPU: zamba2-1.2b (Mamba2 layers and the one shared attention
block, applied at every attention point).

``train_loss`` and its gradients on JAX's weights agree with JAX's within
one bfloat16 ulp of each leaf's largest gradient
(``torch_lm_train_parity``); ``remat`` of the Mamba2 layers leaves the loss
and every gradient unchanged, bit for bit; four steps of
``registry.make_train_step`` agree with JAX's jitted step.
"""
from torch_lm_train_parity import (check_loss_and_grads,
                                   check_remat_bit_for_bit,
                                   check_train_steps, train_family)
from torch_serve_parity import one_torch_thread  # noqa: F401

ARCH = 'zamba2-1.2b'


def test_train_loss_and_grads_match_jax():
    gaps = check_loss_and_grads(train_family(ARCH))
    print(f'{ARCH}: worst leaf {max(gaps, key=gaps.get)} '
          f'{max(gaps.values()):.2e}')


def test_remat_is_bit_for_bit():
    check_remat_bit_for_bit(ARCH)


def test_train_steps_match_jax():
    check_train_steps(train_family(ARCH))
