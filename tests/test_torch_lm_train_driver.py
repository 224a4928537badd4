"""The port's LM train driver (``repro_torch.launch.train``), its example
(``repro_torch.tools.train_lm``) and ``analysis.flops``, on the CPU.

The driver's loss falls over 8 steps at the JAX test's settings
(``tests/test_integration.py``); a run interrupted at step 3 and resumed
from its checkpoint equals the run never interrupted, bit for bit
(``tests/test_checkpoint.py``'s property, where JAX allows 1e-5); the
whisper path trains on ``_frames_for``'s frames, which agree with JAX's
within 1e-6; bfloat16 weights survive a checkpoint bit for bit; the CLI
runs on ``--device cpu`` and raises without a card when none is named.
``flops.param_count``, ``model_flops`` and ``hbm_bytes_decode`` equal
JAX's exactly for every LM config and shape.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import flops as jflops
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import train as jtrain

from repro_torch import configs as tconfigs
from repro_torch.analysis import flops as tflops
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import SHAPES
from repro_torch.launch import train as ttrain
from repro_torch.models import registry
from repro_torch.optim import adam
from repro_torch.tools import train_lm
from torch_serve_parity import one_torch_thread  # noqa: F401

QUIET = dict(log_every=0, print_fn=lambda *a, **k: None)


def test_train_driver_loss_decreases():
    # warmup sized to the run, as the JAX test sizes it
    _, _, hist = ttrain.train('smollm-360m', steps=8, batch=2, seq=64,
                              lr=3e-3, warmup=2, device='cpu', **QUIET)
    assert len(hist) == 8 and all(np.isfinite(hist))
    assert hist[-1] < hist[0], hist


def test_train_resume_is_bit_for_bit(tmp_path):
    """Interrupted at 3 and resumed == uninterrupted: the weights, the
    optimizer state and the resumed steps' losses, bit for bit."""
    kw = dict(steps=6, batch=2, seq=32, ckpt_every=3, device='cpu', **QUIET)
    m_full, o_full, h_full = ttrain.train('smollm-360m', ckpt_dir='', **kw)
    d = str(tmp_path / 'ck')
    _, _, h_head = ttrain.train('smollm-360m', ckpt_dir=d,
                                **dict(kw, steps=3))
    lines = []
    m_res, o_res, h_tail = ttrain.train(
        'smollm-360m', ckpt_dir=d, **dict(kw, print_fn=lines.append))
    assert lines == ['resumed from step 3']
    assert h_head + h_tail == h_full
    for (name, a), (_, b) in zip(m_full.named_parameters(),
                                 m_res.named_parameters()):
        assert torch.equal(a, b), name
    assert int(o_res.step) == int(o_full.step) == 6
    for a, b in zip(o_full.mu + o_full.nu, o_res.mu + o_res.nu):
        assert torch.equal(a, b)
    assert CheckpointManager(d).all_steps() == [3, 6]


def test_whisper_trains_on_jax_frames():
    cfg = tconfigs.get_config('whisper-base').reduced()
    jcfg = jconfigs.get_config('whisper-base').reduced()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    want = np.asarray(jtrain._frames_for(jcfg, tokens))
    got = ttrain._frames_for(cfg, torch.tensor(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    _, _, hist = ttrain.train('whisper-base', steps=3, batch=2, seq=16,
                              lr=3e-3, warmup=1, device='cpu', **QUIET)
    assert len(hist) == 3 and all(np.isfinite(hist))


def test_bfloat16_weights_survive_a_checkpoint(tmp_path):
    cfg = tconfigs.get_config('smollm-360m').reduced(dtype='bfloat16')
    model = registry.init_params(0, cfg, device='cpu')
    opt = adam.init(list(model.parameters()),
                    adam.AdamConfig(state_dtype=torch.bfloat16))
    mgr = CheckpointManager(tmp_path)
    mgr.save(ttrain.train_state(model, opt), step=1)
    mgr.wait()
    other = registry.init_params(1, cfg, device='cpu')
    (named, opt2), step, _ = mgr.restore_latest(
        ttrain.train_state(other, opt))
    assert step == 1
    for k, p in model.named_parameters():
        assert named[k].dtype == torch.bfloat16 and torch.equal(named[k], p)
    assert opt2.mu[0].dtype == torch.bfloat16


def test_cli_trains_on_the_cpu_and_refuses_a_silent_fallback(capsys,
                                                             monkeypatch):
    ttrain.main(['--device', 'cpu', '--arch', 'smollm-360m', '--steps', '2',
                 '--batch', '2', '--seq', '16'])
    out = capsys.readouterr().out
    assert 'step     0  loss' in out and 'final loss' in out
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ttrain.main(['--arch', 'smollm-360m', '--steps', '1'])
    with pytest.raises(NotImplementedError, match='mesh'):
        ttrain.train('smollm-360m', steps=1, mesh=object(), device='cpu')


def test_train_lm_example_runs(tmp_path, capsys):
    train_lm.main(['--device', 'cpu', '--steps', '3', '--batch', '2',
                   '--seq', '64', '--ckpt-dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert 'model: 4L d=256 -> ' in out and 'step    0  loss' in out
    assert 'done; checkpoints: []' in out


@pytest.mark.parametrize('shape', list(SHAPES))
@pytest.mark.parametrize('arch', tconfigs.ALL_LM_ARCHS)
def test_flops_equal_jax(arch, shape):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for active in (False, True):
        assert tflops.param_count(cfg, active_only=active) == \
            jflops.param_count(jcfg, active_only=active)
    assert tflops.model_flops(cfg, SHAPES[shape]) == \
        jflops.model_flops(jcfg, JSHAPES[shape])
    assert tflops.hbm_bytes_decode(cfg, SHAPES[shape]) == \
        jflops.hbm_bytes_decode(jcfg, JSHAPES[shape])
