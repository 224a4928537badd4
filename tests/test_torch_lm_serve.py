"""The port's continuous-batching LM token server
(``repro_torch.launch.serve``), registry and configs against the JAX
package's, on the CPU.

Every config name resolves to the same values as JAX's.  JAX's reduced
``run()`` and the port's, on the JAX server's weights, emit the same tokens
request by request, in the same ticks.  The reference couples requests
through its one scalar decode position (ROADMAP queue 3):
``test_reference_batching_fault_is_pinned`` pins it in both packages.  The
registry serves every family, with logits of JAX's shapes.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import registry as jreg

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as treg
from torch_serve_parity import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ('granite-moe-1b-a400m', 'llama4-maverick-400b-a17b',
            'whisper-base', 'xlstm-1.3b', 'zamba2-1.2b')


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_configs_resolve_every_name_as_jax():
    names = set(jconfigs._MODULES)
    assert names == set(tconfigs._MODULES) and 'lumina-3dgs' in names
    assert tconfigs.ALL_LM_ARCHS == jconfigs.ALL_LM_ARCHS
    for name in names:
        want = dataclasses.asdict(jconfigs.get_config(name))
        assert dataclasses.asdict(tconfigs.get_config(name)) == want, name
    for arch in tconfigs.ALL_LM_ARCHS:
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(jcfg.reduced())
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        for shape in jbase.SHAPES:
            assert tbase.shape_applicable(cfg, tbase.SHAPES[shape]) == \
                jbase.shape_applicable(jcfg, jbase.SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.LONG_CONTEXT_FAMILIES == jbase.LONG_CONTEXT_FAMILIES


@pytest.mark.parametrize('arch', FAMILIES)
def test_registry_serves_every_family(arch):
    """Every entry point returns for each family, and the prefill and
    decode logits are finite, of JAX's shapes."""
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = tconfigs.get_config(arch).reduced()
    ctx = treg.make_ctx(None, cfg)
    b, s = 2, 6
    jbatch = {'tokens': jax.ShapeDtypeStruct((b, s), jnp.int32)}
    batch = {'tokens': torch.ones((b, s), dtype=torch.int32)}
    if cfg.family == 'encdec':
        jbatch['frames'] = jax.ShapeDtypeStruct((b, s, cfg.d_model),
                                                jnp.float32)
        batch['frames'] = torch.ones((b, s, cfg.d_model))
    jctx = jreg.make_ctx(None, jcfg)
    jparams = jreg.abstract_params(jcfg)
    want = jax.eval_shape(jreg.make_prefill(jcfg, jctx), jparams, jbatch)
    jstate = jreg.abstract_decode_state(jcfg, b, 8)
    want_step, _ = jax.eval_shape(jreg.make_decode_step(jcfg, jctx), jparams,
                                  jax.ShapeDtypeStruct((b, 1), jnp.int32),
                                  jstate, jnp.int32(0))

    assert treg.module_for(cfg).__name__.split('.')[-1] == \
        jreg.module_for(jcfg).__name__.split('.')[-1]
    params = treg.init_params(0, cfg, device='cpu')
    lg = treg.make_prefill(cfg, ctx)(params, batch)
    assert tuple(lg.shape) == want.shape and bool(torch.isfinite(lg).all())
    state = treg.init_decode_state(cfg, b, 8, device='cpu')
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(state)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jstate)]
    lg, state = treg.make_decode_step(cfg, ctx)(
        params, torch.ones((b, 1), dtype=torch.int32), state, 0)
    assert tuple(lg.shape) == want_step.shape
    assert bool(torch.isfinite(lg).all())
    server = tserve.Server(arch, slots=2, max_seq=8, device='cpu')
    assert server.cfg == cfg


def test_registry_has_no_mesh_and_no_silent_cpu(monkeypatch):
    cfg = tconfigs.get_config('smollm-360m').reduced()
    with pytest.raises(NotImplementedError, match='mesh'):
        treg.make_ctx(object(), cfg)
    ctx = treg.make_ctx(None, cfg)
    assert (ctx.recipe, ctx.tp) == ('dp', 1)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tserve.Server('smollm-360m')


# --- the server ------------------------------------------------------------

def _serve_both(monkeypatch, arch, **kw):
    """``run(arch, **kw)`` in both packages, the port on the JAX server's
    weights.  Returns ``(jax stats, port stats, jax server, port server)``;
    each server keeps the requests it finished in ``finished``."""
    servers = {}

    def recording(base, key, load=None):
        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                if load is not None:
                    self.params = load(self.cfg)
                self.finished = []
                servers[key] = self

            def step(self):
                out = super().step()
                self.finished.extend(out)
                return out
        return Recording

    monkeypatch.setattr(jserve, 'Server', recording(jserve.Server, 'jax'))
    jstats = jserve.run(arch, print_fn=lambda *_: None, **kw)
    jparams = _np_tree(servers['jax'].params)
    monkeypatch.setattr(tserve, 'Server', recording(
        tserve.Server, 'port',
        lambda cfg: interop.lm_params_from_numpy(jparams, cfg,
                                                 device='cpu')))
    tstats = tserve.run(arch, device='cpu', print_fn=lambda *_: None, **kw)
    return jstats, tstats, servers['jax'], servers['port']


def _outs(server):
    return {r.rid: list(r.out) for r in server.finished}


@pytest.mark.parametrize('arch,kw', [
    ('smollm-360m', dict(slots=2, n_requests=3, prompt_len=4, max_new=4,
                         max_seq=32)),
    # later admissions decode at a position past max_seq - 1 and stop early
    ('chameleon-34b', dict(slots=3, n_requests=5, prompt_len=5, max_new=8,
                           max_seq=12))])
def test_server_matches_jax(monkeypatch, arch, kw):
    jstats, tstats, jsrv, tsrv = _serve_both(monkeypatch, arch, **kw)
    for key in ('requests', 'completed', 'ticks', 'tokens'):
        assert tstats[key] == jstats[key], key
    assert tstats['completed'] == kw['n_requests']
    stopped_early = tstats['tokens'] < kw['n_requests'] * kw['max_new']
    assert stopped_early == (kw['max_seq'] == 12)
    assert _outs(tsrv) == _outs(jsrv)
    assert [r.rid for r in tsrv.finished] == [r.rid for r in jsrv.finished]
    assert tsrv.slot_pos == jsrv.slot_pos


def test_reference_batching_fault_is_pinned(monkeypatch):
    """The reference's ``Server.admit`` teacher-forces a prompt through the
    batched decode step, which writes K/V at the slot's position in every
    row: admitting request 1 overwrites request 0's prompt K/V, and
    request 0's tokens change.  Both packages do so, token for token
    (ROADMAP queue 3: ``launch/serve.py`` couples requests through one
    scalar ``pos``)."""
    kw = dict(slots=2, prompt_len=4, max_new=6, max_seq=32)
    alone = _serve_both(monkeypatch, 'smollm-360m', n_requests=1, **kw)
    paired = _serve_both(monkeypatch, 'smollm-360m', n_requests=2, **kw)
    for _, _, jsrv, tsrv in (alone, paired):
        assert _outs(tsrv) == _outs(jsrv)
    assert _outs(alone[2]) == {0: [430, 263, 276, 430, 263, 456]}
    assert _outs(paired[2])[0] == [430, 499, 284, 499, 284, 499]
    for i in (2, 3):        # the jax and the port server
        k_alone = np.asarray(alone[i].state[0])[:, 0, :4] if i == 2 else \
            alone[i].state[0][:, 0, :4].numpy()
        k_paired = np.asarray(paired[i].state[0])[:, 0, :4] if i == 2 else \
            paired[i].state[0][:, 0, :4].numpy()
        assert np.abs(k_alone - k_paired).max() > 0.5


def test_serve_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve', '--arch',
         'smollm-360m', '--device', 'cpu', '--slots', '2', '--requests', '3',
         '--prompt-len', '4', '--max-new', '4', '--max-seq', '32'],
        capture_output=True, text=True, timeout=120,
        env={'PYTHONPATH': str(ROOT / 'src'), 'PATH': '/usr/bin:/bin',
             'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr
    assert 'smollm-360m: 3/3 requests, 6 ticks, 12 tokens' in out.stdout


def test_serve_lm_tool_serves_a_recurrent_family_on_the_cpu():
    out = subprocess.run(
        [sys.executable, '-m', 'repro_torch.tools.serve_lm', '--arch',
         'xlstm-1.3b', '--device', 'cpu', '--requests', '3'],
        capture_output=True, text=True, timeout=120,
        env={'PYTHONPATH': str(ROOT / 'src'), 'PATH': '/usr/bin:/bin',
             'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr
    assert 'xlstm-1.3b: 3/3 requests, ' in out.stdout
    assert ' tokens, ' in out.stdout and out.stdout.rstrip().endswith(
        'tok/s on cpu')
