"""The port's Chrome trace export (``repro_torch.obs.export``) against the
JAX package's (``repro.obs.export``), on the CPU.

* The same tracer calls on a fixed clock export to the same Chrome
  trace-event payload in both packages: schema, named track lanes in a
  stable order, microsecond timestamps from the earliest event,
  thread-scoped instants (``tests/test_obs.py:75``); ``track_spans`` reads
  the same spans back; ``write_trace`` writes what ``to_chrome_trace``
  builds.
* ``validate_chrome_trace`` rejects each malformed payload with the JAX
  validator's message (``tests/test_obs.py:102``).
* A sync-driver serving run records the same span structure (per track,
  ``(ph, name, depth, args)`` in order) as the JAX package's run on the
  same sessions (``tests/test_obs.py:218``), and two port replays agree.
* A threaded run's exported trace validates, holds host, host-worker and
  device lanes, and its worker lane holds one ``plan_tick`` span for each
  plan the worker made: each event from the two threads lands once.  That
  a worker span overlaps a device span (``tests/test_obs.py:250``) is not
  held here: on the CPU the port's device work is done when dispatch
  returns, so the device window is near empty; ``chip_smoke.py`` prints the
  overlap on the card.

64x64, ``structured_scene(PRNGKey(7), 800)``, 2 private slots.
"""
import json

import pytest

from repro import obs as jobs
from repro.core import pipeline as jpipe
from repro.serve import session as jsession
from repro.serve import stepper as jstepper

from repro_torch import obs as tobs
from repro_torch.core import pipeline as tpipe
from repro_torch.serve import session as tsession
from repro_torch.serve import stepper as tstepper
from torch_serve_parity import (one_torch_thread,  # noqa: F401
                                port_sessions, sessions, trajs)
from torch_stepper_parity import make_scene, to_cam

ARRIVALS = (0, 0, 1, 6, 9)
PROCESS = 'serve'


def _clock():
    """A deterministic clock: 0.5 ms a reading."""
    t = [10.0]

    def tick():
        t[0] += 5e-4
        return t[0]
    return tick


def _record(tracer):
    """The same calls on either package's tracer: nested host spans, an
    explicit device window, instants on two tracks, an unknown track."""
    with tracer.span('tick', tick=0):
        with tracer.span('plan_tick', tick=0):
            tracer.instant('admit', slot=1, sid=7)
        tracer.complete('shade', 10.002, 10.00225, tick=0, slots=2)
    tracer.complete('kernel.prep', 10.003, 10.004, depth=1)
    tracer.instant('arrival', sid=0)
    tracer.instant('restore', track='control', tick=3)
    with tracer.span('plan_tick', track=tobs.TRACK_WORKER, tick=1):
        pass
    return tracer


def test_chrome_trace_equals_jax_schema_and_tracks(tmp_path):
    tt = _record(tobs.Tracer(clock=_clock()))
    jt = _record(jobs.Tracer(clock=_clock()))
    got = tobs.to_chrome_trace(tt.events, process_name=PROCESS)
    want = jobs.to_chrome_trace(jt.events, process_name=PROCESS)
    assert got == want
    events = tobs.validate_chrome_trace(got)
    assert got['displayTimeUnit'] == 'ms'
    lanes = {e['args']['name']: e['tid'] for e in events
             if e['ph'] == 'M' and e['name'] == 'thread_name'}
    assert set(lanes) == {tobs.TRACK_HOST, tobs.TRACK_WORKER,
                          tobs.TRACK_DEVICE, 'control'}
    assert lanes[tobs.TRACK_HOST] < lanes[tobs.TRACK_WORKER] \
        < lanes[tobs.TRACK_DEVICE] < lanes['control']
    assert min(e['ts'] for e in events if e['ph'] != 'M') == 0.0
    assert all(e['s'] == 't' for e in events if e['ph'] == 'i')
    for track in lanes:
        assert tobs.track_spans(got, track) == jobs.track_spans(want, track)
    (shade, prep) = tobs.track_spans(got, tobs.TRACK_DEVICE)
    assert shade[2] == 'shade' and shade[1] - shade[0] == \
        pytest.approx(250.0)
    assert prep[2] == 'kernel.prep'
    assert tobs.track_spans(got, 'no-such-track') == []
    path = tmp_path / 'trace.json'
    written = tobs.write_trace(str(path), tt, process_name=PROCESS)
    assert json.loads(path.read_text()) == written == got
    # the default process name is the port's own
    assert tobs.to_chrome_trace([])['traceEvents'][0]['args'] == \
        {'name': 'repro_torch.serve'}


def _span(**kw):
    rec = {'ph': 'X', 'name': 'x', 'pid': 1, 'tid': 1, 'ts': 0.0,
           'dur': 1.0}
    rec.update(kw)
    return rec


@pytest.mark.parametrize('payload,match', [
    ({'events': []}, 'traceEvents'),
    ([], 'traceEvents'),
    ({'traceEvents': {}}, 'must be a list'),
    ({'traceEvents': [3]}, 'not an object'),
    ({'traceEvents': [{'ph': 'X', 'name': 'x', 'pid': 1}]}, "'tid'"),
    ({'traceEvents': [_span(dur=None)]}, "'dur'"),
    ({'traceEvents': [_span(dur=-1.0)]}, "'dur'"),
    ({'traceEvents': [_span(ts='0')]}, "'ts'"),
    ({'traceEvents': [{'ph': 'i', 'name': 'i', 'pid': 1, 'tid': 1}]},
     '"ts"'),
    ({'traceEvents': [{'ph': 'B', 'name': 'b', 'pid': 1, 'tid': 1}]},
     'unknown phase'),
])
def test_validate_rejects_malformed_as_jax(payload, match):
    with pytest.raises(ValueError, match=match) as got:
        tobs.validate_chrome_trace(payload)
    with pytest.raises(ValueError) as want:
        jobs.validate_chrome_trace(payload)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope='module')
def steppers():
    jscene, tscene = make_scene()
    cam0 = trajs(1, 1)[0][0]
    jst = jstepper.BatchedStepper(
        jscene, jpipe.LuminaConfig(capacity=192, window=3), cam0, 2)
    tst = tstepper.BatchedStepper(
        tscene, tpipe.LuminaConfig(capacity=192, window=3), to_cam(cam0), 2,
        device='cpu')
    return jst, tst


def _traced_run(pkg, stepper, driver):
    session, tracer_cls, make = pkg
    stepper.reset()
    tracer = tracer_cls()
    mgr = session.SessionManager(stepper, 2, tracer=tracer)
    tr = trajs(len(ARRIVALS), 3, spread=72.0, start=0.0)
    for s in make(session.ViewerSession, tr, arrival_tick=ARRIVALS):
        mgr.submit(s)
    mgr.run(driver=driver)
    return tracer, mgr


JAX = (jsession, jobs.Tracer, sessions)
PORT = (tsession, tobs.Tracer, port_sessions)


def test_sync_span_structure_equals_jax(steppers):
    jst, tst = steppers
    jtr, _ = _traced_run(JAX, jst, 'sync')
    ttr, _ = _traced_run(PORT, tst, 'sync')
    again, _ = _traced_run(PORT, tst, 'sync')
    want = jobs.span_structure(jtr.events)
    got = tobs.span_structure(ttr.events)
    assert got == want
    assert tobs.span_structure(again.events) == got
    host_names = {rec[1] for rec in got[tobs.TRACK_HOST]}
    assert {'tick', 'plan_tick', 'apply_plan', 'observe_tick', 'arrival',
            'admit', 'step_dispatch'} <= host_names
    assert any(rec[2] > 0 for rec in got[tobs.TRACK_HOST])
    assert 'shade' in {rec[1] for rec in got[tobs.TRACK_DEVICE]}


def test_threaded_trace_lanes_and_worker_spans(steppers, tmp_path):
    jst, tst = steppers
    ttr, tmgr = _traced_run(PORT, tst, 'threaded')
    jtr, _ = _traced_run(JAX, jst, 'threaded')
    payload = tobs.write_trace(str(tmp_path / 'threaded.json'), ttr)
    tobs.validate_chrome_trace(
        json.loads((tmp_path / 'threaded.json').read_text()))
    worker = tobs.track_spans(payload, tobs.TRACK_WORKER)
    device = tobs.track_spans(payload, tobs.TRACK_DEVICE)
    host = tobs.track_spans(payload, tobs.TRACK_HOST)
    assert worker and device and host
    assert all(name == 'plan_tick' for _, _, name, _ in worker)
    # one worker plan per rendered tick after the first (no fault: every
    # later tick's plan came from the worker), each recorded once
    ticks = sorted(args['tick'] for _, _, _, args in worker)
    assert ticks == sorted(set(ticks)) == list(range(1, tmgr.tick + 1))
    # the same span structure per track as the JAX package's threaded run
    got, want = (tobs.span_structure(ttr.events),
                 jobs.span_structure(jtr.events))
    assert got[tobs.TRACK_WORKER] == want[jobs.TRACK_WORKER]
    assert got[tobs.TRACK_DEVICE] == want[jobs.TRACK_DEVICE]
    # host_ms on every logged tick; the overlap is the card's to show
    assert tmgr.tick_log and all(t['host_ms'] >= 0.0
                                 and t['overlap_ms'] >= 0.0
                                 for t in tmgr.tick_log)


def test_cli_trace_metrics_threaded_and_stream(tmp_path):
    """The CLI's ``--driver threaded``, ``--trace-out``, ``--metrics-out``
    and ``--stream``: the trace validates, the metrics snapshot is JSON,
    and the rollup holds the JAX CLI's keys (``host_ms``/``host_overlap``,
    the ``stream_*`` counters) for the same flags."""
    from repro.serve import render as jrender

    from repro_torch.serve import render as trender
    kw = dict(width=32, gaussians=300, capacity=64,
              print_fn=lambda *a, **k: None)
    lines = []
    trace, metrics = tmp_path / 'trace.json', tmp_path / 'metrics.json'
    got = trender.serve(2, 3, driver='threaded', trace_out=str(trace),
                        metrics_out=str(metrics), device='cpu',
                        **dict(kw, print_fn=lines.append))
    events = tobs.validate_chrome_trace(json.loads(trace.read_text()))
    assert any(e.get('cat') == tobs.TRACK_WORKER for e in events)
    assert 'serve.frames' in json.loads(metrics.read_text())
    assert any(ln.startswith('-- trace: ') for ln in lines)
    assert any('(threaded, ' in ln and 'overlap' in ln for ln in lines)
    want = jrender.serve(2, 3, driver='threaded', **kw)
    assert {'host_ms', 'host_overlap'} <= set(got) & set(want)
    lines.clear()
    got = trender.serve(2, 3, stream=True, stream_budget=600_000,
                        stream_near=3, stream_lod=5, device='cpu',
                        **dict(kw, print_fn=lines.append))
    want = jrender.serve(2, 3, stream=True, stream_budget=600_000,
                         stream_near=3, stream_lod=5, **kw)
    keys = {k for k in want if k.startswith('stream_')}
    assert keys and keys <= set(got)
    assert got['stream_stalls'] == 0 and got['stream_loads'] > 0
    assert any(ln.startswith('-- streaming: ') for ln in lines)
    with pytest.raises(SystemExit):
        trender.serve(2, 2, stream=True, sequential=True, device='cpu', **kw)
