"""The port's hardware model (``repro_torch.core.hwmodel``) against the JAX
package's, on the CPU.

The model is analytic: it turns statistics measured on a run into modeled
times and energies of the paper's hardware (a mobile Volta GPU, LuminCore,
GSCore).  Fixture: ``structured_scene(PRNGKey(0), 1200)`` and
``orbit_trajectory(6, 64, 64)``, capacity 256 and window 6, as
``tests/test_integration.py``'s hardware-model tests use them.

* ``measure_frame`` on the port's baseline aux equals JAX's on the same
  frame exactly (float64 sums of equal integers);
* fed the same statistics, every stage, energy and variant number, and
  ``rescale_to_paper_mix``, agrees with JAX's within 1e-12 relative;
* the orderings of ``test_hwmodel_orderings`` and the bounds of
  ``test_masked_fraction_matches_paper_ballpark`` hold on the port's own
  run.
"""
import jax
import numpy as np
import pytest

from repro.core import hwmodel as jhw
from repro.core import pipeline as jpipe
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

from repro_torch import interop
from repro_torch.core import hwmodel as thw
from repro_torch.core import pipeline as tpipe
from torch_serve_parity import one_torch_thread  # noqa: F401

GAUSSIANS, WIDTH, CAPACITY, WINDOW = 1200, 64, 256, 6
HIT_RATES = (0.0, 0.37, 0.91)


@pytest.fixture(scope='module')
def inputs():
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(0), GAUSSIANS)
    cams = jax_orbit(6, width=WIDTH, height_px=WIDTH)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in scene],
                                      device='cpu')
    tcams = [interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                       c.cy, c.width, c.height, c.near, c.far,
                                       device='cpu') for c in cams]
    jcfg = jpipe.LuminaConfig(capacity=CAPACITY, window=WINDOW)
    render = jax.jit(lambda c: jpipe.render_frame_baseline(scene, c, jcfg))
    jstats = []
    for i, c in enumerate(cams):
        _, _, aux, lists = render(c)
        jstats.append(jhw.measure_frame(
            lists, aux, hit_rate=HIT_RATES[i % 3],
            sorted_this_frame=1.0 / WINDOW))
    return dict(tscene=tscene, tcams=tcams, jstats=jstats,
                tcfg=tpipe.LuminaConfig(capacity=CAPACITY, window=WINDOW))


def to_port(s: jhw.FrameHWStats) -> thw.FrameHWStats:
    return thw.FrameHWStats(*(float(x) for x in s))


def close(got, want, rel=1e-12):
    return got == pytest.approx(want, rel=rel, abs=0)


@pytest.mark.parametrize('frame', [0, 2, 5])
def test_measure_frame_equals_jax(inputs, frame):
    _, _, aux, lists = tpipe.render_frame_baseline(
        inputs['tscene'], inputs['tcams'][frame], inputs['tcfg'],
        device='cpu')
    got = thw.measure_frame(lists, aux, hit_rate=HIT_RATES[frame % 3],
                            sorted_this_frame=1.0 / WINDOW)
    want = inputs['jstats'][frame]
    assert tuple(got) == tuple(float(x) for x in want)
    assert got.masked_fraction == want.masked_fraction
    assert got.sig_fraction == want.sig_fraction
    assert got.iterated > got.significant > 0


@pytest.mark.parametrize('window', [1, 6])
def test_evaluate_variants_matches_jax(inputs, window):
    jstats = inputs['jstats']
    tstats = [to_port(s) for s in jstats]
    for jtab, ttab in (
            (jhw.evaluate_variants(jstats, window=window),
             thw.evaluate_variants(tstats, window=window)),
            (jhw.evaluate_variants([jhw.rescale_to_paper_mix(s)
                                    for s in jstats], window=window),
             thw.evaluate_variants([thw.rescale_to_paper_mix(s)
                                    for s in tstats], window=window))):
        assert list(ttab) == list(jtab) == list(thw.VARIANTS) + ['GSCore']
        for v, row in jtab.items():
            for key, want in row.items():
                assert close(ttab[v][key], float(want)), (v, key)
    for s, t in zip(jstats, tstats):
        for got, want in zip(thw.rescale_to_paper_mix(t),
                             jhw.rescale_to_paper_mix(s)):
            assert close(got, float(want))


@pytest.mark.parametrize('rc', [False, True])
def test_stage_and_energy_models_match_jax(inputs, rc):
    for s in inputs['jstats']:
        t = to_port(s)
        jg, tg = jhw.gpu_stage_times(s, rc=rc), thw.gpu_stage_times(t, rc=rc)
        assert tg.keys() == jg.keys()
        for k in jg:
            assert close(tg[k], jg[k]), k
        assert close(thw.nru_raster_time(t, rc=rc), jhw.nru_raster_time(s, rc=rc))
        assert close(thw.gpu_energy(t, tg, rc=rc), jhw.gpu_energy(s, jg, rc=rc))
        assert close(thw.lumincore_energy(t, rc=rc, s2=True),
                     jhw.lumincore_energy(s, rc=rc, s2=True))
        assert close(thw.gscore_raster_time(t), jhw.gscore_raster_time(s))
        assert close(thw.gscore_energy(t), jhw.gscore_energy(s))
        for v in thw.VARIANTS:
            assert close(thw.variant_frame_time(v, t),
                         jhw.variant_frame_time(v, s)), v
            assert close(thw.variant_energy(v, t), jhw.variant_energy(v, s)), v
    with pytest.raises(ValueError):
        thw.variant_frame_time('TPU', to_port(inputs['jstats'][0]))


def test_hwmodel_orderings_hold_in_the_port(inputs):
    """``tests/test_integration.py::test_hwmodel_orderings`` on the port's
    own run: hit rates from ``LuminSys``, statistics from the baseline."""
    cfg = inputs['tcfg']
    sys_ = tpipe.LuminSys(inputs['tscene'], cfg, inputs['tcams'][0],
                          device='cpu')
    stats = []
    for cam in inputs['tcams']:
        _, st = sys_.step(cam)
        _, _, aux, lists = tpipe.render_frame_baseline(
            inputs['tscene'], cam, cfg, device='cpu')
        stats.append(thw.measure_frame(lists, aux,
                                       hit_rate=float(st.hit_rate),
                                       sorted_this_frame=1.0 / cfg.window))
    table = thw.evaluate_variants(stats)
    sp = {v: m['speedup'] for v, m in table.items()}
    en = {v: m['norm_energy'] for v, m in table.items()}
    assert sp['Lumina'] >= sp['S2-Acc'] >= sp['NRU+GPU'] > 1.0
    assert sp['Lumina'] > sp['GPU'] == 1.0
    assert sp['RC-GPU'] < sp['NRU+GPU']
    assert en['Lumina'] < en['NRU+GPU'] < 1.0
    assert 0 < sp['GSCore'] < sp['Lumina']


def test_masked_fraction_matches_paper_ballpark(inputs):
    _, _, aux, lists = tpipe.render_frame_baseline(
        inputs['tscene'], inputs['tcams'][0],
        tpipe.LuminaConfig(capacity=CAPACITY), device='cpu')
    s = thw.measure_frame(lists, aux)
    assert 0.5 < s.masked_fraction < 0.99
    assert 0.02 < s.sig_fraction < 0.5
