"""The port's LM training for the encdec and ssm families against the JAX
package, on the CPU: whisper-base (the encoder over seeded frames, then
the teacher-forced decoder) and xlstm-1.3b (one super-block of an mLSTM
and an sLSTM block).  zamba2 is in ``test_torch_lm_train_hybrid.py``.

``train_loss`` and its gradients on JAX's weights agree with JAX's: xlstm,
with no attention, within 1e-5 of each leaf's largest gradient, whisper
within one bfloat16 ulp (``torch_lm_train_parity``); ``remat`` (whisper has
none, as in JAX) leaves the loss and every gradient unchanged, bit for
bit; four steps of ``registry.make_train_step`` agree with JAX's jitted
step for xlstm.
"""
import pytest

from torch_lm_train_parity import (check_loss_and_grads,
                                   check_remat_bit_for_bit,
                                   check_train_steps, train_family)
from torch_serve_parity import one_torch_thread  # noqa: F401

FAMILIES = ('whisper-base', 'xlstm-1.3b')


@pytest.mark.parametrize('arch', FAMILIES)
def test_train_loss_and_grads_match_jax(arch):
    gaps = check_loss_and_grads(train_family(arch))
    print(f'{arch}: worst leaf {max(gaps, key=gaps.get)} '
          f'{max(gaps.values()):.2e}')


@pytest.mark.parametrize('arch', FAMILIES)
def test_remat_is_bit_for_bit(arch):
    check_remat_bit_for_bit(arch)


def test_train_steps_match_jax():
    check_train_steps(train_family('xlstm-1.3b'))
