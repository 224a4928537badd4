"""Helpers for the parity tests of the port's LM training
(``tests/test_torch_lm_train*.py``): each family's ``train_loss``, its
gradients and ``registry.make_train_step`` on JAX's weights, on the CPU.

Tolerances (each a fraction of the largest absolute gradient of the same
leaf).  A model without attention (xlstm) meets JAX's gradients within
``GRAD_TOL_SCAN`` (1e-5).  The families with attention run
``flash_attention``, which rounds Q x scale, K, P and V to bfloat16 in both
packages, and their backward passes round the cotangents there to
bfloat16 too: a float32 sum that differs from XLA's in its last bit can
flip such a rounding, which moves the gradient by up to one bfloat16 ulp
(2^-8, 3.9e-3 relative).  ``GRAD_TOL_FLASH`` (4e-3) is that ulp; the
worst leaves on these fixtures are 6.2e-6 (zamba2) to 1.6e-3 (whisper)
apart (``pytest -s`` prints them).  Losses agree within 1e-6 relative.

Chained train steps.  The first step's loss is the same forward on the
same weights, within 1e-6.  Each step then moves every weight by about
the learning rate times the sign of its gradient, so a gradient element
that a flipped rounding moves across zero moves its weight by up to
2 x lr.  Later losses therefore part by more than the forward's 1e-6: by
the fourth step 5.7e-6 (smollm), 1.5e-5 (granite, zamba2) relative, and
7.1e-8 for xlstm, whose path has no such rounding (``pytest -s`` prints
them).  ``STEP_RTOL_*`` bounds them at 1e-4 for the families with
attention and 1e-5 for xlstm; grad norms within 1e-3 (measured up to
1.4e-4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.optim import adam as jadam

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import registry as treg
from repro_torch.optim import adam as tadam
from torch_lm_parity import jax_batch, jax_init, leaf_of, np_tree, t

GRAD_TOL_SCAN, GRAD_TOL_FLASH = 1e-5, 4e-3
LOSS_RTOL = 1e-6
B, S, S_ENC = 2, 16, 16
STEPS, STEP_LR = 4, 3e-3
STEP_RTOL_SCAN, STEP_RTOL_FLASH = 1e-5, 1e-4


def grad_tol(cfg) -> float:
    return GRAD_TOL_SCAN if cfg.family == 'ssm' else GRAD_TOL_FLASH


def train_batch(jcfg, seed: int) -> dict:
    """Seeded next-token ``tokens`` and ``labels`` [B, S] with the last two
    labels of row 0 set to -1 (ignored), and for ``encdec`` seeded
    standard-normal frames [B, S_ENC, D] (numpy)."""
    data = jax_batch(seed, 0, B, S, jcfg.vocab)
    labels = np.array(data['labels'])
    labels[0, -2:] = -1
    out = {'tokens': np.asarray(data['tokens']), 'labels': labels}
    if jcfg.family == 'encdec':
        out['frames'] = np.random.default_rng(seed).standard_normal(
            (B, S_ENC, jcfg.d_model)).astype(np.float32)
    return out


def port_batch(data: dict) -> dict:
    return {k: t(v) for k, v in data.items()}


def port_model(fam: dict, **overrides):
    """A fresh port model on JAX's weights (``overrides`` replace fields
    of its config, e.g. ``remat=True``)."""
    cfg = tconfigs.get_config(fam['arch']).reduced(**overrides)
    return interop.lm_params_from_numpy(fam['params'], cfg, device='cpu'), cfg


def port_loss_grads(model, cfg, data: dict):
    """The port's loss and its gradients, by parameter name."""
    mod = treg.module_for(cfg)
    loss = mod.train_loss(model, port_batch(data), cfg,
                          treg.make_ctx(None, cfg))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


@functools.cache
def train_family(arch: str, seed: int = 0) -> dict:
    """A reduced config's JAX weights, a seeded batch, and JAX's loss and
    gradients of ``train_loss`` on them (jitted; once a process)."""
    jcfg = jconfigs.get_config(arch).reduced()
    params = jax_init(seed, jcfg)
    data = train_batch(jcfg, seed)
    ctx = jreg.make_ctx(None, jcfg)
    mod = jreg.module_for(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, d: mod.train_loss(p, d, jcfg, ctx)))(params, data)
    return dict(arch=arch, jcfg=jcfg, params=np_tree(params), data=data,
                loss=float(loss), grads=np_tree(grads))


def check_loss_and_grads(fam: dict) -> dict:
    """The port's ``train_loss`` and gradients on JAX's weights against
    JAX's; returns each leaf's gap over its largest gradient."""
    model, cfg = port_model(fam)
    loss, grads = port_loss_grads(model, cfg, fam['data'])
    assert abs(float(loss) - fam['loss']) <= LOSS_RTOL * abs(fam['loss']), \
        (float(loss), fam['loss'])
    gaps = {}
    for name, g in grads.items():
        want = leaf_of(fam['grads'], name).astype(np.float32)
        got = g.float().numpy()
        assert got.shape == want.shape, name
        peak = float(np.abs(want).max())
        gaps[name] = float(np.abs(got - want).max()) / max(peak, 1e-30)
        assert gaps[name] <= grad_tol(cfg), (name, gaps[name])
    return gaps


def check_remat_bit_for_bit(arch: str) -> None:
    """On the port's own weights: loss and every gradient with ``remat``
    equal those without it, bit for bit."""
    cfg = tconfigs.get_config(arch).reduced()
    data = train_batch(cfg, 3)
    out = []
    for remat in (False, True):
        c = tconfigs.get_config(arch).reduced(remat=remat)
        model = treg.init_params(3, c, device='cpu')
        out.append(port_loss_grads(model, c, data))
    (loss0, g0), (loss1, g1) = out
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def check_train_steps(fam: dict) -> None:
    """``STEPS`` steps of ``make_train_step`` (lr 3e-3, float32 moments)
    on the fixed batch, from JAX's weights, against JAX's jitted step: the
    first loss within 1e-6 relative and the later ones within the
    family's step bound (the module docstring), grad norms within 1e-3,
    and the last loss below the first on both sides
    (``tests/test_models.py``'s property)."""
    jcfg, data = fam['jcfg'], fam['data']
    jstep, jacfg = jreg.make_train_step(
        jcfg, jreg.make_ctx(None, jcfg),
        jadam.AdamConfig(lr=STEP_LR, state_dtype=jnp.float32))
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, fam['params'])
    jopt = jadam.init(jp, jacfg)
    model, cfg = port_model(fam)
    tstep, tacfg = treg.make_train_step(
        cfg, treg.make_ctx(None, cfg),
        tadam.AdamConfig(lr=STEP_LR, state_dtype=torch.float32))
    topt = tadam.init(list(model.parameters()), tacfg)
    tb = port_batch(data)
    want, got = [], []
    for _ in range(STEPS):
        jp, jopt, jm = jstep(jp, jopt, data)
        model, topt, tm = tstep(model, topt, tb)
        want.append((float(jm['loss']), float(jm['grad_norm'])))
        got.append((float(tm['loss']), float(tm['grad_norm'])))
    rtol = STEP_RTOL_SCAN if cfg.family == 'ssm' else STEP_RTOL_FLASH
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= (rtol if i else LOSS_RTOL) * abs(wl), \
            (got, want)
        assert abs(gn - wn) <= 1e-3 * abs(wn), (got, want)
    assert got[-1][0] < got[0][0] and want[-1][0] < want[0][0], (got, want)
    assert int(topt.step) == STEPS
    print(f"{fam['arch']}: step losses' relative gaps "
          f'{[abs(g[0] - w[0]) / w[0] for g, w in zip(got, want)]}, '
          f"grad norms' {[abs(g[1] - w[1]) / w[1] for g, w in zip(got, want)]}")
