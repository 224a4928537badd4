"""The port's token server against the JAX package's for the moe, encdec,
ssm and hybrid families, on the CPU.

For each of the five configs, reduced, JAX's ``run()`` and the port's, on
the JAX server's weights, emit the same tokens request by request, in the
same ticks, with the same completions and final slot positions.  Four
requests share two slots, so two slots are reused: the xlstm server's
partial state reset on admission (ROADMAP queue 3) runs in both.
"""
import numpy as np
import pytest

from test_torch_lm_serve import _outs, _serve_both
from torch_lm_parity import FAMILIES
from torch_serve_parity import one_torch_thread  # noqa: F401

KW = dict(slots=2, n_requests=4, prompt_len=4, max_new=4, max_seq=32)


@pytest.mark.parametrize('arch', FAMILIES)
def test_server_matches_jax(monkeypatch, arch):
    jstats, tstats, jsrv, tsrv = _serve_both(monkeypatch, arch, **KW)
    for key in ('requests', 'completed', 'ticks', 'tokens'):
        assert tstats[key] == jstats[key], key
    assert tstats['completed'] == KW['n_requests']
    assert tstats['tokens'] == KW['n_requests'] * KW['max_new']
    assert _outs(tsrv) == _outs(jsrv)
    assert [r.rid for r in tsrv.finished] == [r.rid for r in jsrv.finished]
    assert tsrv.slot_pos == jsrv.slot_pos
    if tsrv.cfg.family == 'encdec':
        # the served whisper decodes against zero cross K/V (queue 3)
        for jc, tc in zip(jsrv.state['cross'], tsrv.state['cross']):
            assert not np.asarray(jc).any() and not tc.any()
