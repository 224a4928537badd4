"""The chunk loops' checkpoints, on the CPU: ``layers.flash_attention``'s q
and kv blocks and ``linear_scan.chunked_linear_attention``'s chunks, each
under ``layers.remat`` while grad is on and there are several, as the JAX
package nests ``jax.checkpoint`` in its two scans.

The loops as the port ran them before the checkpoints are copied below
(``plain_flash``, ``plain_scan``) as oracles.  At B = 2, S = 48, heads 3
(flash: ``q_chunk`` 16, ``kv_chunk`` 8, so 3 x 6 blocks, and the mixed
3 x 1 and 1 x 6 loops; the scan: chunk 12, so 4 chunks) and in one-block
cases:

  (a) the forward, with grad on and under ``torch.no_grad()``, equals the
      oracle's bit for bit, in float32 and bfloat16;
  (b) the gradients equal the oracle's bit for bit, and JAX's
      ``jax.grad`` of its own function on the same numpy inputs: the
      scan's output within ``TOL`` and its gradients within 1e-5 of each
      one's largest entry (float32 throughout); flash's outputs within
      ``FLIP_TOL`` and its gradients within ``flip_close`` (one bfloat16
      ulp of the largest entry each, 1e-3 relative L2): its bfloat16
      roundings of P and of the cotangents turn 1-ulp float32 gaps of the
      two packages' sums into bfloat16 flips;
  (c) the bytes that autograd saves during the forward
      (``op_count.saved_bytes``), less the inputs': with several blocks,
      flash's stay below the kv carries (m, l, acc) of every block plus
      the inputs' bytes, and no [B, qc, H, kc] storage is saved; the
      scan's stay below one float32 state a chunk plus the inputs' bytes,
      and no [B, H, w, w] or float32 chunk copy is saved; with one block
      each loop saves exactly what the oracle saves;
  (d) smollm-360m cut to 2 layers at ``train_4k`` on the single mesh: the
      port's dry-run peak a rank against the JAX package's
      ``memory_analysis`` temporaries of the same cell, both counted by
      ``tools/dryrun_peaks.py`` in subprocesses (``repro.launch.dryrun``
      fixes its device count at import), and no flash block among the 20
      largest groups live at the port's peak.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import linear_scan as jscan

from repro_torch.analysis.op_count import saved_bytes
from repro_torch.models import layers as L
from repro_torch.models import linear_scan as tscan
from torch_lm_parity import FLIP_TOL, TOL, assert_close, t
from torch_serve_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, S, H, HD = 2, 48, 3, 4
# (q_chunk, kv_chunk): 3 x 6 blocks, 3 x 1, 1 x 6, and one block
FLASH_CHUNKS = ((16, 8), (16, 48), (48, 8), (512, 1024))
DK, DV = 4, 5
# chunk widths: 4 chunks of 12, and one chunk
SCAN_CHUNKS = (12, 512)
DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# The oracles: the port's loops before the checkpoints
# ---------------------------------------------------------------------------


def plain_flash(q, k, v, *, causal: bool, q_offset=0, q_chunk: int = 512,
                kv_chunk: int = 1024):
    b, s, h, hd = q.shape
    t = k.shape[1]
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    kc = min(kv_chunk, t)
    while t % kc:
        kc -= 1
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(s // qc):
        q32 = q[:, qi * qc:(qi + 1) * qc].float() * scale
        qpos = qi * qc + torch.arange(qc, device=dev) + q_offset
        m = torch.full((b, qc, h), L.NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, qc, h), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, h, hd), dtype=torch.float32, device=dev)
        for kj in range(t // kc):
            k_c = k[:, kj * kc:(kj + 1) * kc]
            v_c = v[:, kj * kc:(kj + 1) * kc]
            sc = L._bf16_dot('bqhd,bkhd->bqhk', q32, k_c)
            if causal:
                kpos = kj * kc + torch.arange(kc, device=dev)
                mask = kpos[None, :] > qpos[:, None]
                sc = torch.where(mask[None, :, None, :], L.NEG_INF, sc)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + L._bf16_dot('bqhk,bkhd->bqhd', p,
                                                      v_c)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def plain_scan(q, k, v, log_a, *, chunk: int = 512, normalize: bool = False,
               state_in=None):
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if normalize:
        v = tscan._with_ones(v)
    w = min(chunk, s)
    while s % w:
        w -= 1
    state = state_in if state_in is not None else torch.zeros(
        (b, h, dk, v.shape[-1]), dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(s // w):
        qc, kc, vc = (x[:, c * w:(c + 1) * w].float() for x in (q, k, v))
        f = torch.cumsum(log_a[:, c * w:(c + 1) * w].float(), dim=1)
        f_tot = f[:, -1]
        qk = torch.einsum('bthd,bshd->bhts', qc, kc)
        fh = f.permute(0, 2, 1)
        decay = fh[:, :, :, None] - fh[:, :, None, :]
        gate = torch.exp(torch.where(tri, decay, L.NEG_INF))
        intra = torch.einsum('bhts,bshv->bthv', qk * gate, vc)
        qs = qc * torch.exp(f)[..., None]
        inter = torch.einsum('bthd,bhdv->bthv', qs, state)
        ys.append(intra + inter)
        kd = kc * torch.exp(f_tot[:, None] - f)[..., None]
        outer = torch.einsum('bshd,bshv->bhdv', kd, vc)
        state = state * torch.exp(f_tot)[..., None, None] + outer
    y = torch.cat(ys, dim=1)
    if normalize:
        y = tscan._normalized(y, dv)
    return y.to(q.dtype), state


# ---------------------------------------------------------------------------
# Inputs and helpers
# ---------------------------------------------------------------------------


def _flash_np(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, HD)).astype(np.float32)
                 for _ in range(4))                          # q, k, v, ct


def _scan_np(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, DK)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, DK)) / 2).astype(np.float32)
    v = rng.standard_normal((B, S, H, DV)).astype(np.float32)
    # log-decays in [-0.5, -0.01], as the sigmoid forget gates give
    log_a = (-rng.uniform(0.01, 0.5, (B, S, H))).astype(np.float32)
    ct = rng.standard_normal((B, S, H, DV)).astype(np.float32)
    return q, k, v, log_a, ct


def _leaves(arrays, dtype) -> list:
    return [t(a).to(dtype).requires_grad_() for a in arrays]


def _grads(out, ct, ins) -> tuple:
    return torch.autograd.grad((out.float() * t(ct)).sum(), ins)


def _saved_shapes(fn, *args) -> list:
    """The (shape, dtype) of every tensor autograd saves during
    ``fn(*args)``, as ``saved_tensors_hooks`` sees them."""
    seen = []

    def pack(x):
        seen.append((tuple(x.shape), x.dtype))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn(*args)
    return seen


def flip_close(got, want) -> None:
    """Each entry within one bfloat16 ulp (2^-8 relative) of the largest
    of ``want``, and the whole within 1e-3 relative L2.  Seen over 32
    draws of the FLASH_CHUNKS cases: 9.8e-4 at most (one ulp at 0.25, of
    entries up to 1.06), 1.7e-4 relative L2; most gradients bit for bit."""
    got = got.detach().numpy()
    want = np.asarray(want)
    gap = got - want
    assert np.abs(gap).max() <= 2.0 ** -8 * np.abs(want).max(), gap
    assert np.linalg.norm(gap) <= 1e-3 * np.linalg.norm(want)


def scale_close(got, want, rel: float = 1e-5) -> None:
    """Each entry within ``rel`` of the largest of ``want``: the scan's
    gradients against JAX's, float32 sums in another order (seen over 16
    draws of the SCAN_CHUNKS cases: 3.8e-6 at most, at one chunk of 48
    with the normalizer)."""
    want = np.asarray(want)
    gap = np.abs(got.detach().numpy() - want).max()
    assert gap <= rel * np.abs(want).max(), gap


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _blocks(s: int, q_chunk: int, kv_chunk: int) -> tuple:
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    while s % qc:
        qc -= 1
    while s % kc:
        kc -= 1
    return qc, kc


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('causal', (True, False))
@pytest.mark.parametrize('q_chunk,kv_chunk', FLASH_CHUNKS)
def test_flash_forward_and_gradients_are_the_plain_loops(
        q_chunk, kv_chunk, causal, dtype):
    """(a) and (b) against the oracle: bit for bit."""
    *qkv, ct = _flash_np(1)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    ins = _leaves(qkv, dtype)
    got = L.flash_attention(*ins, **kw)
    with torch.no_grad():
        got_ng = L.flash_attention(*ins, **kw)
    want = plain_flash(*ins, **kw)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got_ng, want)
    for g, w in zip(_grads(got, ct, ins), _grads(want, ct, ins)):
        assert torch.equal(g, w)


@pytest.mark.parametrize('causal', (True, False))
@pytest.mark.parametrize('q_chunk,kv_chunk', FLASH_CHUNKS)
def test_flash_gradients_match_jax(q_chunk, kv_chunk, causal):
    """(b) against ``jax.grad`` of the JAX package's ``flash_attention``
    (float32 inputs): the output within ``FLIP_TOL``, each gradient within
    ``flip_close``."""
    *qkv, ct = _flash_np(2)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)

    def loss(q, k, v):
        y = jlayers.flash_attention(q, k, v, **kw)
        return jnp.sum(y * ct), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, qkv))
    ins = _leaves(qkv, torch.float32)
    y = L.flash_attention(*ins, **kw)
    assert_close(y, want_y, FLIP_TOL)
    for g, w in zip(_grads(y, ct, ins), want_g):
        flip_close(g, w)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('q_chunk,kv_chunk', FLASH_CHUNKS)
def test_flash_saves_no_block(q_chunk, kv_chunk, dtype):
    """(c): with several blocks, no [B, qc, H, kc] storage, and under
    the inputs' bytes plus, a q block, the carries (m, l, acc) of each kv
    block and two more sets of that size (its scaled q, made once, and
    the final division's operands) and its positions: all that a q block
    run plain keeps, none of it where a q block is checkpointed; with one
    block, the oracle's bytes."""
    qkv = _leaves(_flash_np(3)[:3], dtype)
    qc, kc = _blocks(S, q_chunk, kv_chunk)
    nq, nk = S // qc, S // kc

    def run(fn):
        return lambda *x: fn(*x, causal=True, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)

    got, y = saved_bytes(run(L.flash_attention), *qkv, inputs=qkv)
    want, y_plain = saved_bytes(run(plain_flash), *qkv, inputs=qkv)
    assert torch.equal(y, y_plain)
    block = B * qc * H * kc * 4
    assert want >= nq * nk * 2 * block, (want, block)   # sc and p a block
    if nq == nk == 1:
        assert got == want
        return
    carries = nq * ((nk + 2) * B * qc * H * (HD + 2) * 4 + qc * 8)
    assert got <= carries + _nbytes(*qkv), (got, carries)
    shapes = [s for s, _ in _saved_shapes(run(L.flash_attention), *qkv)]
    assert (B, qc, H, kc) not in shapes, shapes


def test_attend_on_dtensors_checkpoints_the_blocks(monkeypatch):
    """``attend`` on DTensors (the partitioned programs) runs
    ``flash_attention`` on each rank's block (``local_map``), its blocks
    checkpointed: on a one-rank gloo mesh, with ``flash_attention``'s
    chunks set to 16 x 8, the checkpoints are taken and the output and
    gradients are the oracle's bit for bit."""
    import functools
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    calls = []
    real = L.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    kw = dict(q_chunk=16, kv_chunk=8)
    monkeypatch.setattr(L, 'checkpoint', counted)
    monkeypatch.setattr(L, 'flash_attention',
                        functools.partial(L.flash_attention, **kw))
    *qkv, ct = _flash_np(4)
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh('cpu', (1,))
        ins = [distribute_tensor(t(x), mesh, [Replicate()]).requires_grad_()
               for x in qkv]
        y = L.attend(*ins, causal=True)
        assert calls.count('_q_step') == 3
        assert calls.count('_kv_step') == 3 * 6
        grads = torch.autograd.grad((y * distribute_tensor(
            t(ct), mesh, [Replicate()])).sum(), ins)
        # each q block's recompute takes its kv blocks' checkpoints again
        assert calls.count('_kv_step') == 2 * 3 * 6
        plain = _leaves(qkv, torch.float32)
        want = plain_flash(*plain, causal=True, **kw)
        assert torch.equal(y.to_local(), want)
        for g, w in zip(grads, _grads(want, ct, plain)):
            assert torch.equal(g.to_local(), w)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# chunked_linear_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('normalize', (False, True))
@pytest.mark.parametrize('chunk', SCAN_CHUNKS)
def test_scan_forward_and_gradients_are_the_plain_loop(chunk, normalize,
                                                       dtype):
    """(a) and (b) against the oracle: y, the final state and every
    gradient (q, k, v, log_a and the initial state) bit for bit."""
    *arrays, ct = _scan_np(5)
    ins = _leaves(arrays, dtype)
    dv = DV + normalize
    s0 = torch.randn((B, H, DK, dv), generator=torch.Generator(
        ).manual_seed(6)).requires_grad_()
    kw = dict(chunk=chunk, normalize=normalize, state_in=s0)
    got, got_s = tscan.chunked_linear_attention(*ins, **kw)
    with torch.no_grad():
        got_ng, got_s_ng = tscan.chunked_linear_attention(*ins, **kw)
    want, want_s = plain_scan(*ins, **kw)
    assert got.dtype == want.dtype == dtype
    for a, b in ((got, want), (got_ng, want), (got_s, want_s),
                 (got_s_ng, want_s)):
        assert torch.equal(a, b)
    ct_s = torch.randn(want_s.shape, generator=torch.Generator(
        ).manual_seed(7))

    def grads(y, st):
        return torch.autograd.grad((y.float() * t(ct)).sum()
                                   + (st * ct_s).sum(), ins + [s0])

    for g, w in zip(grads(got, got_s), grads(want, want_s)):
        assert torch.equal(g, w)


@pytest.mark.parametrize('normalize', (False, True))
@pytest.mark.parametrize('chunk', SCAN_CHUNKS)
def test_scan_gradients_match_jax(chunk, normalize):
    """(b) against ``jax.grad`` of the JAX package's
    ``chunked_linear_attention`` (float32): y within ``TOL``, each
    gradient within ``scale_close``."""
    *arrays, ct = _scan_np(8)
    kw = dict(chunk=chunk, normalize=normalize)

    def loss(q, k, v, log_a):
        y, _ = jscan.chunked_linear_attention(q, k, v, log_a, **kw)
        return jnp.sum(y * ct), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, arrays))
    ins = _leaves(arrays, torch.float32)
    y, _ = tscan.chunked_linear_attention(*ins, **kw)
    assert_close(y, want_y, TOL)
    for g, w in zip(_grads(y, ct, ins), want_g):
        scale_close(g, w)


@pytest.mark.parametrize('normalize', (False, True))
@pytest.mark.parametrize('chunk', SCAN_CHUNKS)
def test_scan_saves_no_chunk(chunk, normalize):
    """(c), on bfloat16 inputs (the models' dtype, so every float32 copy
    is a storage of its own): with several chunks, under a float32 state
    a chunk plus the chunks' inputs (with the normalizer: v with its ones
    column, and the final division's operands, which the plain loop keeps
    too), and no [B, H, w, w] or float32 [B, w, H, *] storage; with one
    chunk, the oracle's bytes."""
    ins = _leaves(_scan_np(9)[:4], torch.bfloat16)
    w = min(chunk, S)
    nc = S // w

    def run(fn):
        return lambda *x: fn(*x, chunk=chunk, normalize=normalize)[0]

    got, y = saved_bytes(run(tscan.chunked_linear_attention), *ins,
                         inputs=ins)
    want, y_plain = saved_bytes(run(plain_scan), *ins, inputs=ins)
    assert torch.equal(y, y_plain)
    if nc == 1:
        assert got == want
        return
    state = B * H * DK * (DV + normalize) * 4
    inputs = _nbytes(*ins)
    if normalize:
        y32 = torch.zeros((B, S, H, DV + 1), requires_grad=True)
        tail, _ = saved_bytes(tscan._normalized, y32, DV)
        inputs += B * S * H * (DV + 1) * 2 + tail
    assert got <= nc * state + inputs, (got, nc * state, inputs)
    assert want > 3 * (nc * state + inputs), want
    for shape, dtype in _saved_shapes(run(tscan.chunked_linear_attention),
                                      *ins):
        assert shape != (B, H, w, w), shape
        assert not (dtype == torch.float32 and shape[:3] == (B, w, H)), shape


# ---------------------------------------------------------------------------
# The checkpoints: where they are taken
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('q_chunk,kv_chunk', FLASH_CHUNKS)
def test_checkpoints_only_loops_of_several_blocks(q_chunk, kv_chunk,
                                                  monkeypatch):
    """Each loop of several blocks checkpoints each block while grad is on;
    a loop of one, and anything under ``torch.no_grad()``, none."""
    calls = []
    real = L.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(L, 'checkpoint', counted)
    qkv = _leaves(_flash_np(10)[:3], torch.float32)
    qc, kc = _blocks(S, q_chunk, kv_chunk)
    nq, nk = S // qc, S // kc
    kw = dict(causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    with torch.no_grad():
        L.flash_attention(*qkv, **kw)
        tscan.chunked_linear_attention(*qkv, qkv[0][..., 0], chunk=kc)
    assert calls == []
    L.flash_attention(*qkv, **kw)
    # the forward takes each checkpoint once (a q block's recompute in the
    # backward takes its kv blocks' again)
    assert calls.count('_q_step') == (nq if nq > 1 else 0)
    assert calls.count('_kv_step') == (nq * nk if nk > 1 else 0)
    calls.clear()
    tscan.chunked_linear_attention(*qkv, -qkv[0][..., 0].abs(), chunk=kc)
    assert calls == (['_chunk_step'] * nk if nk > 1 else [])


# ---------------------------------------------------------------------------
# The dry run against JAX's memory_analysis
# ---------------------------------------------------------------------------

CELL = 'smollm-360m:train_4k:single:n_layers=2'
# The port's peak a rank over JAX's temporaries for CELL, as counted on a
# CPU (torch 2.13, jax 0.9.0; tools/dryrun_peaks.py): 4.2526 / 1.6305 GB
# = 2.61x with the plain loops (their flash blocks 3.2 GB of it), 1.7646 /
# 1.6305 GB = 1.08x with the checkpoints.  The bound leaves room for other
# versions of either package, and the plain loops' 2.61x far above it.
PEAK_OVER_JAX = 1.3
# smollm's flash blocks on one rank of the single mesh: 16 rows, 512
# queries, one of the 16 padded heads, 1,024 keys
FLASH_BLOCK = [16, 512, 1, 1024]


def test_smollm_train_peak_against_jax_memory_analysis():
    """(d) the port's dry-run peak a rank within PEAK_OVER_JAX of JAX's
    temporaries, the argument bytes equal, and no flash block among the
    20 largest groups live at the peak, both counted by
    ``tools/dryrun_peaks.py --jax`` (each side in a subprocess)."""
    run = subprocess.run([sys.executable, str(ROOT / 'tools' /
                                              'dryrun_peaks.py'),
                          '--jax', '--cells', CELL],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert run.returncode == 0, (run.stdout + run.stderr)[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    port, jmem = out['port'], out['jax']
    assert port['args'] == jmem['argument_size_in_bytes']
    ratio = port['peak'] / jmem['temp_size_in_bytes']
    assert ratio < PEAK_OVER_JAX, (port['peak'], jmem)
    assert len(port['live_at_peak']) == 20
    for g in port['live_at_peak']:
        assert g['shape'] != FLASH_BLOCK, g
