"""Pins of three faults of the reference's token server
(``src/repro/launch/serve.py``), which the port reproduces for token
parity (ROADMAP queue 3, "Faults of the reference"), in both packages on
the same weights, on the CPU.

* xlstm: ``Server.admit`` zeroes a reused slot's state arrays of rank 4 or
  more only, the mLSTM state.  The sLSTM ``slstm_h``/``slstm_c`` [ns, B,
  di] keep the previous request's values.
* zamba2 (``hybrid``): a reused slot is not reset at all; it keeps the
  Mamba2 ``conv`` and ``ssm`` states of the request before.
* whisper (``encdec``): the server never calls ``prepare_cross``, so every
  served token's cross attention reads the zero K/V of
  ``init_decode_state`` (checked in ``test_torch_lm_serve_families.py``,
  where the served tokens equal JAX's).

The fixture: one slot, 32 positions, prompts ``synthetic_tokens(7, i, 1,
4, vocab)``; request 0 is served, then request 1 is admitted into the
reused slot, and its logits after the prompt are compared with the same
request admitted into a fresh state.  The leak moves the logits (xlstm by
0.023, zamba2 by 0.23 in JAX); the tokens do not flip on this fixture.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.data.tokens import synthetic_tokens

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from torch_lm_parity import family_tol, np_tree
from torch_serve_parity import one_torch_thread  # noqa: F401


def _snapshot(state):
    return jax.tree.map(
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a, state)


def _admit(server, req):
    """Admit ``req`` into slot 0: (the state the first prompt step sees,
    after the reset, and the logits of the last prompt step, numpy)."""
    seen = []
    inner = server.decode_fn

    def recording(params, tok, state, pos):
        if not seen:
            seen.append(_snapshot(state))
        lg, state = inner(params, tok, state, pos)
        seen.append(lg)
        return lg, state

    server.decode_fn = recording
    try:
        server.admit(req, 0)
    finally:
        server.decode_fn = inner
    lg = seen[-1]
    return seen[0], (lg.numpy() if isinstance(lg, torch.Tensor)
                     else np.asarray(lg))


def _reuse(server, requests) -> dict:
    """Serve request 0 in the one slot, admit request 1 into it, then
    admit request 1 again into the state the server started from."""
    fresh = _snapshot(server.state)
    server.admit(requests[0], 0)
    while server.slot_req[0] is not None:
        server.step()
    leaked, reused = _admit(server, requests[1])
    server.state = fresh
    _, alone = _admit(server, requests[2])
    return dict(leaked=leaked, reused=reused, alone=alone)


def _both(arch: str) -> tuple:
    kw = dict(slots=1, max_seq=32)
    jsrv = jserve.Server(arch, **kw)
    vocab = jsrv.cfg.vocab
    jreqs = [jserve.Request(rid=i, prompt=synthetic_tokens(7, i, 1, 4,
                                                           vocab)[0],
                            max_new=4) for i in (0, 1, 1)]
    tsrv = tserve.Server(arch, device='cpu', **kw)
    tsrv.params = interop.lm_params_from_numpy(np_tree(jsrv.params),
                                               tsrv.cfg, device='cpu')
    treqs = tserve.synthetic_requests(2, 4, 4, vocab, device='cpu')
    treqs.append(tserve.synthetic_requests(2, 4, 4, vocab,
                                           device='cpu')[1])
    return _reuse(jsrv, jreqs), _reuse(tsrv, treqs)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _row(state, path, axis: int) -> np.ndarray:
    for key in path:
        state = state[key]
    return np.take(_np(state), 0, axis=axis)


# (path in the state, the slot's axis)
@pytest.mark.parametrize('arch,leaky,reset', [
    ('xlstm-1.3b', ((('slstm_h',), 1), (('slstm_c',), 1)),
     ((('mlstm',), 2),)),
    ('zamba2-1.2b', ((('ssm', 'conv'), 1), (('ssm', 'ssm'), 1)), ())])
def test_reused_slot_keeps_the_previous_requests_state(arch, leaky, reset):
    jax_run, port_run = _both(arch)
    for run in (jax_run, port_run):
        for path, axis in leaky:
            assert _row(run['leaked'], path, axis).any(), path
        for path, axis in reset:
            assert not _row(run['leaked'], path, axis).any(), path
        assert np.abs(run['reused'] - run['alone']).max() > 1e-3
    for key in ('reused', 'alone'):
        np.testing.assert_allclose(port_run[key], jax_run[key],
                                   **family_tol(tconfigs.get_config(arch)))
