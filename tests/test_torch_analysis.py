"""The port's op counter (``analysis.op_count``) and roofline
(``analysis.roofline``) against the JAX package's ``hlo_parse`` and
``roofline``, on the CPU.

``hlo_parse`` reads XLA's module text and the counter reads the eager op
stream, so each side counts its own program of the same function:

  * the five cases of ``tests/test_hlo_parse.py``, on that file's module
    text, against the same function written in torch (its collectives on
    a ``fake`` process group of 4 ranks, the pods 2 ranks wide): FLOPs,
    collective bytes and counts, the cross-pod split and the bytes model
    equal exactly, and ``F.linear``'s ``t`` + ``mm`` counted as one
    matmul;
  * a compiled ``fori_loop`` of 5 trips: matmul FLOPs and bytes exact, the
    total within the loop's scalar bookkeeping (a counter add a trip, a
    compare a test: ``2 * 5 + 1`` FLOPs; one s32 a test: ``4 * 6``
    bytes);
  * smollm-360m at its published widths, cut to 2 layers, forward of
    1 x 64 tokens: matmul FLOPs equal to the compiled JAX forward's
    exactly, all FLOPs within ``FORWARD_REL`` (4.4 % as run: XLA's CPU
    module converts the bfloat16 weights to float32 with an elementwise
    op, one FLOP an element, where the counter counts the port's
    ``_to_copy`` as bytes);
  * ``FlopCounterMode`` equal to the counter's matmul FLOPs, and the same
    counts on ``meta`` as on the CPU, for every family's train step;
  * the roofline: the row's keys and round trip, ``fmt_seconds`` and
    ``fmt_table`` equal to JAX's strings, ``t_compute * peak`` equal to
    the FLOPs in both packages.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import test_hlo_parse as thp
from repro.analysis import hlo_parse as hp
from repro.analysis import roofline as jrl
from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro.models import transformer as jtr

from repro_torch import kernels
from repro_torch.analysis import op_count, roofline as trl
from repro_torch.configs import get_config as tget
from repro_torch.models import registry as treg
from repro_torch.optim import adam as tadam
from torch_serve_parity import one_torch_thread  # noqa: F401

TRIPS = 5
FORWARD_REL = 0.05
FAMILY_ARCHS = ('smollm-360m', 'granite-moe-1b-a400m', 'whisper-base',
                'xlstm-1.3b', 'zamba2-1.2b')
COUNT_KEYS = ('flops', 'dot_flops', 'bytes', 'n_ops', 'peak_bytes')


@pytest.fixture(scope='module')
def fake_world():
    """A ``fake`` process group of 4 ranks (this process rank 0) and its
    sub-group {0, 1}, torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=4)
    yield dist.new_group([0, 1])
    dist.destroy_process_group()


def module_fn(group01):
    """``thp.MODULE`` in torch: a dot, then 5 trips of an all-gather over
    {0, 1}, a slice and an add, and an all-reduce of the dot over all 4."""
    def main(a, b):
        mm = a @ b
        x = mm
        for _ in range(TRIPS):
            ag = torch.empty((16, 4), device=x.device)
            dist.all_gather_into_tensor(ag, x, group=group01)
            x = x + ag[0:8]
        dist.all_reduce(mm)
        return x
    return main


def module_counts(group01, pod_size=10 ** 9, device='cpu'):
    a = torch.ones((8, 16), device=device)
    b = torch.ones((16, 4), device=device)
    return op_count.analyze(module_fn(group01), a, b, pod_size=pod_size)


def test_dot_flops_exact(fake_world):
    got = module_counts(fake_world)
    want = hp.analyze_text(thp.MODULE)
    assert got['flops'] == want['flops'] == 1024 + 32 * TRIPS
    assert got['dot_flops'] == 1024


def test_trip_count_applied_to_collectives(fake_world):
    got = module_counts(fake_world)
    want = hp.analyze_text(thp.MODULE)
    assert got['collective_bytes'] == want['collective_bytes']
    assert got['collective_counts'] == want['collective_counts'] == {
        'all-gather': TRIPS, 'all-reduce': 1}


@pytest.mark.parametrize('pod_size', [2, 4, 10 ** 9])
def test_crosspod_split(fake_world, pod_size):
    got = module_counts(fake_world, pod_size)
    want = hp.analyze_text(thp.MODULE, pod_size=pod_size)
    assert got['collective_bytes_crosspod'] == \
        want['collective_bytes_crosspod']
    assert got['collective_bytes_crosspod'] == (128 if pod_size == 2 else 0)


def test_bytes_model_counts_moves_and_dots_only(fake_world):
    got = module_counts(fake_world)
    want = hp.analyze_text(thp.MODULE)
    assert got['bytes'] == want['bytes']


def test_meta_counts_the_module_as_the_cpu_does(fake_world):
    assert module_counts(fake_world, 2, 'meta') == module_counts(fake_world,
                                                                 2)


def linear_fn(x, w):
    return F.linear(x, w)


def test_linear_counted_once():
    x, w = torch.ones((3, 5)), torch.ones((7, 5))
    got = op_count.analyze(linear_fn, x, w)
    text = jax.jit(lambda x, w: x @ w.T).lower(
        jax.ShapeDtypeStruct((3, 5), jnp.float32),
        jax.ShapeDtypeStruct((7, 5), jnp.float32)).compile().as_text()
    want = hp.analyze_text(text)
    assert got['n_ops'] == 2          # aten.t (a view) and aten.mm
    assert got['flops'] == got['dot_flops'] == want['flops'] == 2 * 3 * 7 * 5
    assert got['bytes'] == want['bytes']
    assert got['entry'] == 'linear_fn'


def _compiled(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(fn).lower(*args).compile().as_text()


def test_fori_loop_fixture():
    def jfn(a, b):
        y = a @ b
        return jax.lax.fori_loop(0, TRIPS, lambda i, y: y + jnp.tanh(y), y)

    def tfn(a, b):
        y = a @ b
        for _ in range(TRIPS):
            y = y + torch.tanh(y)
        return y

    whole = hp.analyze_text(_compiled(jfn, (8, 16), (16, 4)))
    dot = hp.analyze_text(_compiled(lambda a, b: a @ b, (8, 16), (16, 4)))
    got = op_count.analyze(tfn, torch.ones((8, 16)), torch.ones((16, 4)))
    assert got['dot_flops'] == dot['flops'] == 1024
    assert got['bytes'] == dot['bytes'] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert got['flops'] == 1024 + TRIPS * 2 * 32
    # the loop's bookkeeping: a counter add a trip and a compare a test
    # (11 FLOPs as run), one s32 scalar a test at most (4 bytes as run)
    assert 0 <= whole['flops'] - got['flops'] <= 2 * TRIPS + 1
    assert 0 <= whole['bytes'] - got['bytes'] <= 4 * (TRIPS + 1)


def jax_dot_flops(text, monkeypatch) -> float:
    """hlo_parse's FLOPs of ``text`` less those with its dot FLOPs set to
    0: the module's matmul FLOPs, trip counts applied."""
    total = hp.analyze_text(text)['flops']
    with monkeypatch.context() as m:
        m.setattr(hp, '_dot_flops', lambda rest, symbols: 0.0)
        rest = hp.analyze_text(text)['flops']
    return total - rest


def test_smollm_forward_against_hlo_parse(monkeypatch):
    jcfg = dataclasses.replace(jget('smollm-360m'), n_layers=2)
    tcfg = dataclasses.replace(tget('smollm-360m'), n_layers=2)
    jctx = jreg.make_ctx(None, jcfg)
    text = jax.jit(lambda p, t: jtr.forward(p, t, jcfg, jctx)).lower(
        jreg.abstract_params(jcfg, 1),
        jax.ShapeDtypeStruct((1, 64), jnp.int32)).compile().as_text()
    want = hp.analyze_text(text)
    model = treg.abstract_params(tcfg)
    got = op_count.analyze(model, torch.empty((1, 64), dtype=torch.int32,
                                              device='meta'))
    assert got['dot_flops'] == jax_dot_flops(text, monkeypatch)
    assert abs(got['flops'] - want['flops']) <= FORWARD_REL * want['flops']


def family_step(arch: str, device: str):
    """(train step, its arguments) of ``arch``'s reduced config on
    ``device``: weights seeded 0 (shapes only on ``meta``), 2 x 32
    tokens."""
    cfg = tget(arch).reduced()
    model = (treg.abstract_params(cfg) if device == 'meta'
             else treg.init_params(0, cfg, device=device))
    step, acfg = treg.make_train_step(cfg, treg.make_ctx(None, cfg))
    opt = tadam.init(list(model.parameters()), acfg)
    tok = torch.zeros((2, 32), dtype=torch.int32, device=device)
    batch = {'tokens': tok, 'labels': tok}
    if cfg.family == 'encdec':
        batch['frames'] = torch.zeros((2, 32, cfg.d_model),
                                      dtype=getattr(torch, cfg.dtype),
                                      device=device)
    return step, (model, opt, batch)


@pytest.mark.parametrize('arch', FAMILY_ARCHS)
def test_flop_counter_mode_equals_dot_flops(arch):
    step, args = family_step(arch, 'meta')
    fc = FlopCounterMode(display=False)
    counter = op_count.OpCounter()
    with fc, counter:
        step(*args)
    assert counter.counts()['dot_flops'] == fc.get_total_flops() > 0


@pytest.mark.parametrize('arch', FAMILY_ARCHS)
def test_same_count_on_meta_and_cpu(arch):
    got = {}
    for dev in ('meta', 'cpu'):
        step, args = family_step(arch, dev)
        got[dev] = op_count.analyze(step, *args)
    assert {k: got['meta'][k] for k in COUNT_KEYS} == \
        {k: got['cpu'][k] for k in COUNT_KEYS}


def test_peak_bytes_follows_frees():
    def churn(x):
        for _ in range(10):
            y = x * 2.0
        keep = [x + float(i) for i in range(3)]
        return y, keep

    got = op_count.analyze(churn, torch.ones(1000))
    # two products alive at once, then the last one and three sums
    assert got['peak_bytes'] == 4 * 4000
    assert got['flops'] == 13 * 1000


def test_live_at_peak_lists_the_peak_storages():
    """``live_at_peak`` lists what was live when the peak was first
    reached, freed since or not, and nothing made after it."""
    def churn(x):
        a = x * 2.0                      # 4,000 B
        b = torch.cat([a, a])            # 8,000 B: the peak, 12,000 B
        del a, b
        c = x + 1.0                      # made after the peak
        return c, x.new_zeros(3)

    got = op_count.analyze(churn, torch.ones(1000), live_at_peak=True)
    assert got['peak_bytes'] == 12000
    assert sorted(got['live_at_peak']) == [
        (4000, ('mul', (1000,), 'torch.float32', 'forward')),
        (8000, ('cat', (2000,), 'torch.float32', 'forward'))]
    # a backward's storages carry its phase
    w = torch.ones(1000, requires_grad=True)
    got = op_count.analyze(
        lambda: torch.autograd.grad((w * w).sum(), [w]), live_at_peak=True)
    assert {label[3] for _, label in got['live_at_peak']} == {
        'forward', 'backward'}
    assert 'live_at_peak' not in op_count.analyze(churn, torch.ones(10))


def test_kernel_launches_listed_at_zero_cost(monkeypatch):
    monkeypatch.setitem(kernels.LAUNCHES, 'rasterize', 7)

    def launch():
        kernels.LAUNCHES['rasterize'] += 2

    got = op_count.analyze(launch)
    assert got['kernels'] == {'rasterize': 2}
    assert (got['flops'], got['bytes'], got['n_ops']) == (0, 0, 0)


def test_convolution_against_flop_counter_mode():
    x = torch.ones((2, 3, 16), requires_grad=True)
    w = torch.ones((5, 3, 4), requires_grad=True)

    def conv():
        F.conv1d(x, w).sum().backward()

    fc = FlopCounterMode(display=False)
    counter = op_count.OpCounter()
    with fc, counter:
        conv()
    forward = 2 * 2 * 5 * 13 * 3 * 4
    assert counter.counts()['dot_flops'] == fc.get_total_flops() == \
        3 * forward


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

COUNTS = {'flops': 3.1e15, 'bytes': 7.5e11, 'collective_bytes': 2.5e9,
          'collective_bytes_crosspod': 1.0e9,
          'collective_counts': {'all-reduce': 4, 'all-gather': 2}}
MEMORY = {'argument_size_in_bytes': 10, 'output_size_in_bytes': 20,
          'temp_size_in_bytes': 30, 'alias_size_in_bytes': 0,
          'generated_code_size_in_bytes': 5}


def port_row(**kw):
    return trl.from_counts('smollm-360m', 'train_4k', 'single', 256, COUNTS,
                           model_flops=1.2e17, memory=MEMORY, note='x',
                           **kw)


def jax_row():
    return jrl.Roofline(
        arch='smollm-360m', shape='train_4k', mesh='single', chips=256,
        flops_per_chip=COUNTS['flops'], bytes_per_chip=COUNTS['bytes'],
        coll_bytes_per_chip=COUNTS['collective_bytes'],
        coll_bytes_crosspod_per_chip=COUNTS['collective_bytes_crosspod'],
        collective_counts=COUNTS['collective_counts'], model_flops=1.2e17,
        bytes_per_device_hbm=65.0, note='x').finalize()


def test_roofline_terms_against_jax():
    got, want = port_row(), jax_row()
    assert set(got.row()) == set(want.row())
    assert got.t_compute * trl.PEAK_BF16_PER_S == \
        want.t_compute * jrl.PEAK_FLOPS == COUNTS['flops']
    assert got.t_memory * trl.PEAK_BYTES_PER_S == COUNTS['bytes']
    assert got.t_collective * trl.NVLINK_BYTES_PER_S == \
        COUNTS['collective_bytes']
    assert got.bytes_per_device_hbm == want.bytes_per_device_hbm == 65.0
    assert got.useful_ratio == want.useful_ratio
    assert got.step_time == max(got.t_compute, got.t_memory,
                                got.t_collective)
    assert got.roofline_fraction == pytest.approx(
        1.2e17 / (256 * trl.PEAK_BF16_PER_S) / got.step_time, rel=1e-15)


def test_roofline_row_round_trip(tmp_path):
    rows = [port_row().row(), port_row().row() | {'arch': 'yi-34b'}]
    path = str(tmp_path / 'rows.json')
    trl.save_rows(rows, path)
    assert trl.load_rows(path) == json.loads(json.dumps(rows))
    assert jrl.load_rows(path) == trl.load_rows(path)


@pytest.mark.parametrize('x', [0.0, 3e-7, 1e-6, 4.2e-5, 1e-3, 0.01234, 0.5,
                               1.0, 12.3456, 3600.0])
def test_fmt_seconds_matches_jax(x):
    assert trl.fmt_seconds(x) == jrl.fmt_seconds(x)


def test_fmt_table_matches_jax():
    rows = [port_row().row(), jax_row().row() | {'arch': 'lumina-3dgs',
                                                 'shape': 'render_1080p'}]
    assert trl.fmt_table(rows) == jrl.fmt_table(rows)
