"""The port's cache-aware fine-tuning against the JAX package, on the CPU:
SSIM and PSNR, the scale loss, the oversized-Gaussian scene, the dense
differentiable rasterizer walk, the loss and its gradients, AdamW and the
train step.

Fixtures follow ``tests/test_core_render.py::test_finetune_loss_is_differentiable``:
``structured_scene(PRNGKey(0), 1200)`` (the target scene) and the same key
with ``large_gaussian_frac=0.25`` (the scene being tuned),
``orbit_trajectory(6, 64, 64)``, capacity 64, handed to the port through
``repro_torch.interop``.  Tolerances:

* the dense walk equals the port's chunked walk bit for bit; against the
  JAX package's ``early_exit=False`` walk integers are exact and colors
  within 128 ulps x magnitude;
* the loss and its metrics within 1e-5 relative of ``jax.value_and_grad``;
  each gradient leaf's largest difference within 1e-4 x that leaf's
  largest |g|;
* SSIM within 1e-6 absolute in float32; PSNR within 1e-6 absolute in
  float64 on both sides (JAX under ``jax.enable_x64``) and within 4
  float32 ulps of JAX's float32 value: at 4-32 dB one ulp is 0.5-1.9e-6,
  and JAX's float32 PSNR of these images lies 1.1-1.2e-6 from the float64
  one, so no other float32 summation order is within 1e-6 of it;
* three train steps (one from the same start, one continued from JAX's
  state through ``interop.adam_state_from_numpy``, one continued from the
  port's own scene and state against JAX's chained step): losses within
  1e-4 relative; the moments within 1e-4 x their leaf's largest value;
  parameters within 1e-5 absolute, except elements whose JAX gradient at
  some step is below ``NEAR_ZERO[leaf]`` x that leaf's largest |g|, counted
  per leaf; the exempt elements that differ are bounded at 1 % of the
  parameters.  Adam steps an element whose |g| is far below eps by
  lr x g / eps, so it turns a near-zero gradient's rounding into a
  parameter difference.  ``NEAR_ZERO`` is 1e-6 for every leaf but quats,
  where it is 1e-5: the quats of the oversized Gaussians (three equal
  scales) have a gradient of exactly 0 in exact arithmetic, since their
  rotation leaves the covariance unchanged, and both frameworks' values
  there are rounding noise up to 7.5e-6 x the leaf's largest |g| (9.4e-5).
  At 1e-6, 14 of those elements are not exempt and land up to 3.4e-4
  apart after the first step (ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import finetune as jft
from repro.core import metrics as jmetrics
from repro.core import pipeline as jpipe
from repro.core.gaussians import geometric_mean_scale as jax_gms
from repro.core.projection import project as jproject, recolor as jrecolor
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.optim import adam as jadam

from repro_torch import interop
from repro_torch.core import finetune as tft
from repro_torch.core import gaussians as tgauss
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rasterize as trast
from repro_torch.core.gaussians import FIELDS
from repro_torch.core.projection import Projected, project, recolor
from repro_torch.core.tiling import TileLists
from repro_torch.data.scenes import structured_scene
from repro_torch.optim import adam as tadam
from torch_serve_parity import one_torch_thread  # noqa: F401

GAUSSIANS, WIDTH, CAPACITY, LARGE_FRAC = 1200, 64, 64, 0.25
FT = dict(scale_alpha=8.0, scale_theta=0.03)


def assert_images_ulp_close(got, want, *, ulps=128, err_msg=''):
    """``ulps`` x float32-eps x magnitude (floored at 1.0); copied from
    tests/test_serve.py so this file stands alone."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0)
    err = np.abs(got - want)
    worst = float((err / (np.finfo(np.float32).eps * scale)).max())
    assert (err <= ulps * np.finfo(np.float32).eps * scale).all(), (
        f'{err_msg}: differs by {worst:.0f} ulps (> {ulps} allowed)')


def to_scene(jscene):
    return interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                    device='cpu')


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                     c.cy, c.width, c.height, c.near, c.far,
                                     device='cpu')


@pytest.fixture(scope='module')
def inputs():
    make = jax.jit(jax_structured_scene, static_argnums=(1, 2, 3))
    gt_scene = make(jax.random.PRNGKey(0), GAUSSIANS, (0.015, 0.06), 0.0)
    start = make(jax.random.PRNGKey(0), GAUSSIANS, (0.015, 0.06), LARGE_FRAC)
    cams = jax_orbit(6, width=WIDTH, height_px=WIDTH)
    jcfg = jpipe.LuminaConfig(capacity=CAPACITY)
    render = jax.jit(lambda s, c: jpipe.render_frame_baseline(s, c, jcfg)[0])
    gts = [render(gt_scene, c) for c in cams[:3]]
    return dict(start=start, cams=cams, gts=gts, jcfg=jcfg,
                tcfg=tpipe.LuminaConfig(capacity=CAPACITY),
                tcams=[to_cam(c) for c in cams],
                tgts=[torch.from_numpy(np.array(g)) for g in gts])


# -- metrics and the scale loss ----------------------------------------------

@pytest.mark.parametrize('noise', [None, 0.05])
def test_ssim_and_psnr_match_jax(noise):
    rng = np.random.default_rng(11)
    a = rng.random((40, 48, 3), dtype=np.float32)
    b = (rng.random(a.shape, dtype=np.float32) if noise is None else
         np.clip(a + noise * rng.standard_normal(a.shape), 0, 1)
         .astype(np.float32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got, want = float(tmetrics.ssim(ta, tb)), float(jmetrics.ssim(ja, jb))
    assert abs(got - want) <= 1e-6, (got, want)
    with jax.enable_x64(True):
        want = float(jmetrics.psnr(jnp.asarray(a, jnp.float64),
                                   jnp.asarray(b, jnp.float64)))
    got = float(tmetrics.psnr(ta.double(), tb.double()))
    assert abs(got - want) <= 1e-6, (got, want)
    got, want = float(tmetrics.psnr(ta, tb)), float(jmetrics.psnr(ja, jb))
    assert abs(got - want) <= 4 * float(np.spacing(np.float32(want))), (
        got, want)
    assert float(tmetrics.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)


def test_geometric_mean_scale_and_scale_loss_match_jax(inputs):
    start = inputs['start']
    tstart = to_scene(start)
    np.testing.assert_allclose(tgauss.geometric_mean_scale(tstart).detach(),
                               np.asarray(jax_gms(start)), rtol=1e-6)
    for theta in (0.03, 0.1):
        got = float(tft.scale_loss(tstart, theta).detach())
        want = float(jft.scale_loss(start, theta))
        assert got == pytest.approx(want, rel=1e-6) and want > 0


def test_large_gaussian_frac_keeps_the_default_stream():
    n = 6000
    base = structured_scene(5, n, device='cpu')
    big = structured_scene(5, n, large_gaussian_frac=LARGE_FRAC, device='cpu')
    for f in FIELDS:
        if f != 'log_scales':
            assert torch.equal(getattr(base, f), getattr(big, f)), f
    oversized = (big.log_scales == np.float32(np.log(0.35))).all(dim=1)
    assert abs(float(oversized.float().mean()) - LARGE_FRAC) < 0.02
    assert torch.equal(big.log_scales[~oversized], base.log_scales[~oversized])
    assert torch.equal(structured_scene(5, n, large_gaussian_frac=0.0,
                                        device='cpu').log_scales,
                       base.log_scales)


def test_init_scene_and_param_count():
    gen = torch.Generator().manual_seed(0)
    scene = tgauss.init_scene(gen, 50, extent=2.0, device='cpu')
    assert tgauss.scene_num_params(scene) == 50 * (3 + 3 + 4 + 1 + 3 + 9)
    assert float(scene.means.detach().abs().max()) <= 2.0
    s = tgauss.scales(scene)
    assert float(s.min()) >= 0.04 - 1e-6 and float(s.max()) <= 0.16 + 1e-6


def test_recolor_matches_jax(inputs):
    start, cams = inputs['start'], inputs['cams']
    want = jrecolor(start, cams[3], jproject(start, cams[0]))
    tstart = to_scene(start)
    with torch.no_grad():
        got = recolor(tstart, inputs['tcams'][3],
                      project(tstart, inputs['tcams'][0]))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


# -- the dense walk ------------------------------------------------------------

def _features(inputs, cam_i=0):
    tscene = to_scene(inputs['start'])
    cam = inputs['tcams'][cam_i]
    proj = tpipe.project(tscene, cam)
    lists = tpipe.sort_scene(proj, cam.width, cam.height, CAPACITY)
    return tpipe.gather_tile_features(proj, lists), lists


@pytest.mark.parametrize('width', [1, 3])
def test_gather_backward_drops_the_padding(width):
    """The gather's backward equals plain indexing's on the valid slots and
    gives the -1 padding (which reads row 0) no gradient."""
    gen = torch.Generator().manual_seed(4)
    n, t, k = 50, 6, 40
    idx = torch.randint(-1, n, (t, k), generator=gen, dtype=torch.int32)
    idx[:, 30:] = -1
    table = torch.randn((n, width) if width > 1 else (n,), generator=gen)
    proj = Projected(
        mean2d=table.clone().requires_grad_(), conic=table, color=table,
        radius=table, depth=table, opacity=torch.rand(n, generator=gen),
        valid=torch.ones(n, dtype=torch.bool))
    lists = TileLists(idx, (idx >= 0).sum(1), t, 1)
    got = tpipe.gather_tile_features(proj, lists).mean2d
    assert torch.equal(got.detach(), table[idx.clamp(min=0).long()])
    g = torch.randn(got.shape, generator=gen)
    want_table = table.clone().requires_grad_()
    masked = torch.where((idx >= 0).view(t, k, *([1] * (g.ndim - 2))), g, 0.0)
    want = torch.autograd.grad(
        (want_table[idx.clamp(min=0).long()] * masked).sum(), want_table)[0]
    assert torch.equal(torch.autograd.grad(got, proj.mean2d, g)[0], want)


@pytest.mark.parametrize('live', ['all', 'checker'])
@pytest.mark.parametrize('chunk', [16, 64])
def test_dense_walk_equals_chunked_walk_bit_for_bit(inputs, live, chunk):
    feats, lists = _features(inputs)
    t = feats.ids.shape[0]
    mask = None if live == 'all' else (
        (torch.arange(t)[:, None] + torch.arange(trast.P)[None, :]) % 2 == 0)
    with torch.no_grad():
        want_c, want = trast.rasterize_tiles(feats, lists.tiles_x, live=mask,
                                             chunk=chunk)
    grad_feats = dataclasses.replace(
        feats, mean2d=feats.mean2d.clone().requires_grad_(),
        color=feats.color.clone().requires_grad_())
    got_c, got = trast.rasterize_tiles(grad_feats, lists.tiles_x, live=mask,
                                       chunk=chunk, early_exit=False)
    assert got_c.requires_grad
    assert torch.equal(got_c.detach(), want_c)
    for f in dataclasses.fields(trast.RasterAux):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a.detach(), b), f.name
        assert a.requires_grad == (f.name == 'transmittance'), f.name


def test_dense_baseline_matches_jax_dense(inputs):
    image_j, _, aux_j, lists_j = jax.jit(
        lambda s, c: jpipe.render_frame_baseline(s, c, inputs['jcfg'],
                                                 early_exit=False))(
        inputs['start'], inputs['cams'][1])
    image_t, _, aux_t, lists_t = tpipe.render_frame_baseline(
        to_scene(inputs['start']), inputs['tcams'][1], inputs['tcfg'],
        early_exit=False, device='cpu')
    assert image_t.requires_grad
    np.testing.assert_array_equal(lists_t.indices.numpy(),
                                  np.asarray(lists_j.indices))
    for f in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        np.testing.assert_array_equal(getattr(aux_t, f).numpy(),
                                      np.asarray(getattr(aux_j, f)), f)
    assert_images_ulp_close(image_t.detach().numpy(), image_j,
                            err_msg='dense baseline')
    flat = trast.scatter_tile_pixels(aux_t.n_iterated, lists_t.tiles_x,
                                     lists_t.tiles_y, WIDTH, WIDTH)
    assert flat.shape == (WIDTH, WIDTH)
    assert int(flat.sum()) == int(aux_t.n_iterated.sum())


# -- the loss and its gradients ------------------------------------------------

def _jax_loss_and_grads(inputs, jscene, cam_i, cfg):
    fn = jax.jit(jax.value_and_grad(jft.total_loss, has_aux=True),
                 static_argnums=(3, 4))
    (_, aux), grads = fn(jscene, inputs['cams'][cam_i], inputs['gts'][cam_i],
                         cfg, inputs['jcfg'])
    return aux, [np.asarray(getattr(grads, f)) for f in FIELDS]


def _port_loss_and_grads(inputs, tscene, cam_i, cfg):
    loss, aux = tft.total_loss(tscene, inputs['tcams'][cam_i],
                               inputs['tgts'][cam_i], cfg, inputs['tcfg'],
                               device='cpu')
    grads = torch.autograd.grad(loss, tft.params_of(tscene))
    return aux, [g.numpy() for g in grads]


def test_total_loss_and_gradients_match_jax(inputs):
    jcfg, tcfg = jft.FinetuneConfig(**FT), tft.FinetuneConfig(**FT)
    jaux, jgrads = _jax_loss_and_grads(inputs, inputs['start'], 1, jcfg)
    taux, tgrads = _port_loss_and_grads(inputs, to_scene(inputs['start']), 1,
                                        tcfg)
    for name in jft.FinetuneMetrics._fields:
        assert float(getattr(taux, name)) == pytest.approx(
            float(getattr(jaux, name)), rel=1e-5), name
    assert float(taux.l_scale) > 0 and float(taux.dssim) > 0
    for f, g, w in zip(FIELDS, tgrads, jgrads):
        top = float(np.abs(w).max())
        assert top > 0, f
        assert np.isfinite(g).all(), f
        assert float(np.abs(g - w).max()) <= 1e-4 * top, f


def test_recomputed_chunks_give_the_plain_autograd_gradients(inputs,
                                                             monkeypatch):
    cfg = tft.FinetuneConfig(**FT)
    _, want = _port_loss_and_grads(inputs, to_scene(inputs['start']), 2, cfg)
    calls = []

    def no_recompute(fn, *args, use_reentrant):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(trast, 'checkpoint', no_recompute)
    _, got = _port_loss_and_grads(inputs, to_scene(inputs['start']), 2, cfg)
    assert len(calls) == 1     # K = 64: one chunk of 64
    for f, g, w in zip(FIELDS, got, want):
        assert float(np.abs(g - w).max()) <= 1e-6 * float(np.abs(w).max()), f


def test_dense_walk_recomputes_every_chunk(inputs):
    """Several chunks under grad: each runs checkpointed, and the gradient
    equals the one-chunk walk's."""
    feats, lists = _features(inputs)
    grads = []
    for chunk in (16, 64):
        color = feats.color.clone().requires_grad_()
        f = dataclasses.replace(feats, color=color)
        colors, _ = trast.rasterize_tiles(f, lists.tiles_x, chunk=chunk,
                                          early_exit=False)
        grads.append(torch.autograd.grad(colors.square().sum(), color)[0])
    assert torch.equal(grads[0], grads[1])


# -- AdamW ---------------------------------------------------------------------

ADAM_CASES = {
    'closed_form': (dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                         clip_norm=None), [1.0, -2.0], [0.5, 0.25], np.float32),
    'clip_norm': (dict(lr=0.0, clip_norm=1.0), [0.0, 0.0, 0.0],
                  [3.0, 4.0, 0.0], np.float32),
    'weight_decay_clipped': (dict(lr=0.05, weight_decay=0.1, clip_norm=0.5),
                             [0.3, -0.7, 1.5], [2.0, -1.0, 0.25], np.float32),
    'bf16_state': (dict(), np.ones(16), np.ones(16), 'bfloat16'),
}


@pytest.mark.parametrize('case', list(ADAM_CASES))
def test_adam_step_matches_jax(case):
    kw, p, g, dtype = ADAM_CASES[case]
    bf16 = dtype == 'bfloat16'
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    jcfg = jadam.AdamConfig(**kw, **({'state_dtype': jnp.bfloat16} if bf16
                                     else {}))
    tcfg = tadam.AdamConfig(**kw, **({'state_dtype': torch.bfloat16} if bf16
                                     else {}))
    jp = {'w': jnp.asarray(p, jdt)}
    jg = {'w': jnp.asarray(g, jdt)}
    tp = [torch.tensor(np.asarray(p, np.float32)).to(tdt)]
    tg = [torch.tensor(np.asarray(g, np.float32)).to(tdt)]
    jstate, tstate = jadam.init(jp, jcfg), tadam.init(tp, tcfg)
    for _ in range(2):
        jp, jstate, jnorm = jadam.step(jp, jg, jstate, jcfg)
        tp, tstate, tnorm = tadam.step(tp, tg, tstate, tcfg)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        assert tp[0].dtype == tdt and tstate.mu[0].dtype == tstate.nu[0].dtype
        np.testing.assert_allclose(tp[0].float().numpy(),
                                   np.asarray(jp['w'], np.float32),
                                   rtol=1e-5, atol=1e-7)
        for got, want in ((tstate.mu[0], jstate.mu['w']),
                          (tstate.nu[0], jstate.nu['w'])):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-5, atol=1e-12)
    assert int(tstate.step) == int(jstate.step) == 2
    if case == 'clip_norm':
        assert float(tnorm) == pytest.approx(5.0, abs=1e-5)
    if bf16:
        assert tstate.mu[0].dtype == torch.bfloat16


# -- the train step ------------------------------------------------------------

# per leaf, the fraction of the leaf's largest JAX gradient below which the
# train-step test exempts an element (the module docstring says why quats
# differs)
NEAR_ZERO = {f: 1e-6 for f in FIELDS} | {'quats': 1e-5}


def test_train_steps_match_jax(inputs):
    """Three steps of ``make_train_step`` on both sides.  Step 0 starts both
    from the same scene and a fresh optimizer; step 1 continues the port
    from the JAX run's scene and optimizer state
    (``interop.adam_state_from_numpy``); step 2 continues the port from its
    own scene and state after step 1, against JAX's chained step 2."""
    jcfg, tcfg = jft.FinetuneConfig(**FT), tft.FinetuneConfig(**FT)
    jstep = jft.make_train_step(jcfg, inputs['jcfg'])
    tstep = tft.make_train_step(tcfg, inputs['tcfg'], device='cpu')
    grad_fn = jax.jit(jax.grad(lambda *a: jft.total_loss(*a)[0]),
                      static_argnums=(3, 4))
    jscene, jstate = inputs['start'], jadam.init(inputs['start'], jcfg.adam)
    tscene = to_scene(jscene)
    tstate = tadam.init(tft.params_of(tscene), tcfg.adam)
    n_params = sum(np.asarray(getattr(jscene, f)).size for f in FIELDS)
    exempt = {f: np.zeros(np.shape(getattr(jscene, f)), bool) for f in FIELDS}
    for i in range(3):
        cam, gt = inputs['cams'][i], inputs['gts'][i]
        if i == 1:
            tscene = to_scene(jscene)
            tstate = interop.adam_state_from_numpy(
                jstate.step, [getattr(jstate.mu, f) for f in FIELDS],
                [getattr(jstate.nu, f) for f in FIELDS], device='cpu')
            assert int(tstate.step) == i
        g = grad_fn(jscene, cam, gt, jcfg, inputs['jcfg'])
        for f in FIELDS:
            a = np.abs(np.asarray(getattr(g, f)))
            exempt[f] |= a < NEAR_ZERO[f] * float(a.max())
        jscene, jstate, jaux = jstep(jscene, jstate, cam, gt)
        tscene, tstate, taux = tstep(tscene, tstate, inputs['tcams'][i],
                                     inputs['tgts'][i])
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert float(taux.loss) == pytest.approx(float(jaux.loss), rel=1e-4), i
        off_exempt = {}
        for j, f in enumerate(FIELDS):
            got = getattr(tscene, f).detach().numpy()
            want = np.asarray(getattr(jscene, f))
            off = np.abs(got - want) > 1e-5
            assert not (off & ~exempt[f]).any(), (i, f, float(
                np.abs(got - want)[~exempt[f]].max()))
            off_exempt[f] = int((off & exempt[f]).sum())
            for got_m, want_m in ((tstate.mu[j], getattr(jstate.mu, f)),
                                  (tstate.nu[j], getattr(jstate.nu, f))):
                want_m = np.asarray(want_m)
                assert float(np.abs(got_m.numpy() - want_m).max()) <= \
                    1e-4 * float(np.abs(want_m).max()), (i, f)
        counts = {f: (int(exempt[f].sum()), off_exempt[f]) for f in FIELDS}
        print(f'step {i}: per leaf (elements exempt so far, of them off by '
              f'more than 1e-5): {counts}')
        assert sum(off_exempt.values()) <= 0.01 * n_params, (i, counts)


def test_finetune_tunes_a_copy(inputs):
    tscene = to_scene(inputs['start'])
    before = [p.detach().clone() for p in tft.params_of(tscene)]
    tuned, hist = tft.finetune(tscene, inputs['tcams'][:2], inputs['tgts'][:2],
                               tft.FinetuneConfig(**FT), inputs['tcfg'],
                               steps=2, device='cpu')
    assert len(hist) == 2 and tuned is not tscene
    for p, b in zip(tft.params_of(tscene), before):
        assert torch.equal(p.detach(), b)
    assert not torch.equal(tuned.log_scales.detach(), before[1])
    assert all(np.isfinite(float(h.loss)) for h in hist)
