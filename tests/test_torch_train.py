"""sed_tpu_torch's training path against ``sed_tpu``: losses, augmentation,
AMSGrad, BatchNorm in training mode, the joint train step (plain and
loss-scaled), fresh initialisation, checkpoints and the prefetcher.

Inputs are made with numpy from a seed at a small size: a narrow
``CnnSed`` (conv channels 8/16/16/32, GRU hidden 16), 1 s clips at
16 kHz, weak batch 4 and strong batch 2.  The JAX side is
``sed_tpu.models.zoo.CnnSed`` with its XLA frontend (its training
default); its variables are carried across by ``compat/from_flax``.  The
port runs on the CPU through ``logmel_plain``.  Tolerances are stated
in each test.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sed_tpu import losses as jax_losses
from sed_tpu.augment import functional as jax_aug
from sed_tpu.config import AUDIO_16K
from sed_tpu.models import blocks as jax_blocks
from sed_tpu.models.zoo import CnnSed as JaxCnnSed
from sed_tpu.train.state import SedTrainState
from sed_tpu.train.step import (LossScaleState as JaxLossScaleState,
                                make_train_step as jax_make_train_step)
from sed_tpu_torch import losses
from sed_tpu_torch.augment import functional as aug
from sed_tpu_torch.compat.from_flax import (load_variables,
                                            state_dict_from_variables)
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.train import checkpoint as ckpt
from sed_tpu_torch.train.prefetch import device_prefetch
from sed_tpu_torch.train.state import AmsGrad, create_train_state
from sed_tpu_torch.train.step import (LossScaleState, _GROWTH_INTERVAL,
                                      init_loss_scale, make_train_step)

CFG = AUDIO_16K
NARROW = dict(conv_channels=(8, 16, 16, 32), head='att', gru_hidden=16,
              pad_to_roundup=True)
LR = 1e-3


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(name, rng):
    if name.startswith('clip'):
        shape, okey, tkey = (4, 25), 'clipwise_output', 'target'
    else:
        shape, okey, tkey = (2, 96, 25), 'framewise_output', 'strong_target'
    if name.endswith('logits'):
        out = rng.randn(*shape).astype(np.float32) * 4
    else:
        out = rng.uniform(0.01, 0.99, shape).astype(np.float32)
        out.reshape(-1)[:4] = [0.0, 1.0, 1.0, 0.0]      # saturated sigmoids
    target = (rng.rand(*shape) > 0.5).astype(np.float32)
    if not name.startswith('clip'):
        target = np.concatenate([target, target[:, :4]], axis=1)  # 100 > 96
    target.reshape(-1)[:4] = [0.0, 1.0, 0.0, 1.0]
    return okey, tkey, out, target


@pytest.mark.parametrize('name', sorted(losses.LOSS_REGISTRY))
def test_loss_and_gradient_match_sed_tpu(name):
    """Gradient within 1e-6 elementwise, with exact 0/1 probabilities
    against both targets (``tests/test_train.py:38-55``'s case) and the
    frame losses' truncation to the common frame count.  Value: within
    1e-6 (relative) of a float64 evaluation, and within 2e-6 of
    sed_tpu's, whose float32 mean of 4800 terms lands up to 1.7e-6 off
    float64 (measured; the port's 1.2e-7)."""
    okey, tkey, out, target = _loss_inputs(name, np.random.RandomState(0))
    jfn = jax_losses.get_loss_func(name)
    want, jgrad = jax.value_and_grad(
        lambda o: jfn({okey: o}, {tkey: jnp.asarray(target)}))(
            jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    got = losses.get_loss_func(name)({okey: o},
                                     {tkey: torch.from_numpy(target)})
    got.backward()
    assert np.isfinite(got.item()) and np.isfinite(o.grad.numpy()).all()
    exact = losses.get_loss_func(name)(
        {okey: torch.from_numpy(out).double()},
        {tkey: torch.from_numpy(target).double()}).item()
    assert abs(got.item() - exact) <= 1e-6 * abs(exact)
    assert abs(got.item() - float(want)) <= 2e-6 * abs(exact)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)


def test_bce_is_torch_binary_cross_entropy_and_lets_nan_through():
    """The port's BCE equals ``F.binary_cross_entropy`` (value and
    gradient within 1e-7, saturated probabilities included); a NaN
    probability gives a NaN loss, as sed_tpu's, where torch's kernel
    raises (and asserts on the GPU)."""
    okey, tkey, out, target = _loss_inputs('clip_bce',
                                           np.random.RandomState(2))
    p1 = torch.from_numpy(out).requires_grad_(True)
    p2 = torch.from_numpy(out.copy()).requires_grad_(True)
    t = torch.from_numpy(target)
    a = losses.clip_bce({okey: p1}, {tkey: t})
    b = torch.nn.functional.binary_cross_entropy(p2, t)
    a.backward()
    b.backward()
    assert abs(a.item() - b.item()) <= 1e-7 * b.item()
    torch.testing.assert_close(p1.grad, p2.grad, rtol=1e-7, atol=1e-7)
    out[0, 0] = np.nan
    nan = losses.clip_bce({okey: torch.from_numpy(out)}, {tkey: t})
    assert torch.isnan(nan)
    with pytest.raises(RuntimeError, match='between 0 and 1'):
        torch.nn.functional.binary_cross_entropy(torch.from_numpy(out), t)


# ---------------------------------------------------------------------------
# augmentation: JAX's draws injected, applies compared bitwise
# ---------------------------------------------------------------------------

def _jax_stripes(key, b, total, width, n):
    """``sed_tpu/augment/functional.py:_drop_stripes``'s draws."""
    k1, k2 = jax.random.split(key)
    dist = jax.random.randint(k1, (b, n), 0, width)
    u = jax.random.uniform(k2, (b, n))
    bgn = jnp.floor(u * (total - dist)).astype(jnp.int32)
    return aug.Stripes(torch.from_numpy(np.asarray(bgn, np.int64)),
                       torch.from_numpy(np.asarray(dist, np.int64)))


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_spec_augment_with_jax_draws_is_bitwise(seed):
    x = np.random.RandomState(seed).randn(3, 101, 64, 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_aug.spec_augment(key, jnp.asarray(x)))
    kt, kf = jax.random.split(key)
    draws = (_jax_stripes(kt, 3, 101, 64, 2), _jax_stripes(kf, 3, 64, 8, 2))
    got = aug.apply_spec_augment(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), draws)
    assert np.array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    assert (want == 0).any()


def test_spec_augment_draws_from_the_generator():
    x = torch.ones(64, 1, 101, 64)
    a = aug.spec_augment(x, torch.Generator().manual_seed(5))
    b = aug.spec_augment(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    time_zero = (a[:, 0, :, 0] == 0).sum(1)       # column 0: freq stripes
    assert time_zero.max() <= 2 * 63 and time_zero.sum() > 0
    t, f = aug.draw_spec_augment(torch.Generator().manual_seed(1), x)
    assert t.dist.max() < 64 and f.dist.max() < 8 and t.dist.min() >= 0
    assert ((t.bgn + t.dist) <= 101).all() and ((f.bgn + f.dist) <= 64).all()


@pytest.mark.parametrize('seed', range(6))
def test_timeshift_with_jax_draw_is_bitwise(seed):
    """trunc, not round: the draw's shift is ``jnp.trunc``'s."""
    x = np.random.RandomState(seed).randn(2, 101, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_aug.do_timeshift(key, jnp.asarray(x), axis=1))
    shift = int(np.trunc(90.0 * np.asarray(jax.random.normal(key))))
    got = aug.apply_timeshift(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                              torch.tensor(shift))
    assert np.array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    z = torch.full((), -0.9 / 90)
    assert torch.trunc(0.0 + 90.0 * z) == 0       # (-1, 1) maps to 0


def test_mixup_is_bitwise_and_halves_the_batch():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 50, 8, 1).astype(np.float32)
    lam = np.float32(rng.rand(6))
    want = np.asarray(jax_aug.do_mixup(jnp.asarray(x), jnp.asarray(lam)))
    got = aug.do_mixup(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                       torch.from_numpy(lam))
    assert got.shape == (3, 1, 50, 8)
    assert np.array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    t = (rng.rand(6, 25) > 0.5).astype(np.float32)
    assert np.array_equal(
        aug.do_mixup(torch.from_numpy(t), torch.from_numpy(lam)).numpy(),
        np.asarray(jax_aug.do_mixup(jnp.asarray(t), jnp.asarray(lam))))


@pytest.mark.parametrize('alpha', [1.0, 0.4, 2.5])
def test_mixup_lambda_pairs_and_distribution(alpha):
    lam = aug.mixup_lambda(torch.Generator().manual_seed(0), 4000, alpha)
    assert torch.equal(lam[0::2] + lam[1::2], torch.ones(2000)) or \
        torch.allclose(lam[0::2] + lam[1::2], torch.ones(2000), atol=1e-7)
    first = lam[0::2].double()
    assert abs(first.mean().item() - 0.5) < 0.03
    var = 1.0 / (4 * (2 * alpha + 1))               # beta(a, a) variance
    assert abs(first.var().item() - var) < 0.15 * var


# ---------------------------------------------------------------------------
# AMSGrad
# ---------------------------------------------------------------------------

def _gradient_stream(steps=10):
    """Shrinking and sign-flipping gradients: a 30x shrink after step 1,
    then alternating signs."""
    rng = np.random.RandomState(7)
    base = rng.randn(3, 5).astype(np.float32)
    for t in range(steps):
        scale = 1.0 if t == 0 else (1.0 / 30) * (0.7 ** t)
        sign = 1.0 if t % 3 else -1.0
        yield (base * scale * sign
               + 0.01 * rng.randn(3, 5).astype(np.float32) * scale)


def _against_optax(opt_factory):
    p0 = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    tx = optax.amsgrad(LR, b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = opt_factory([tp])
    worst = 0.0
    for g in _gradient_stream():
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        worst = max(worst, float(np.abs(tp.detach().numpy()
                                        - np.asarray(jp)).max()))
    return worst, opt, js, tp


def test_amsgrad_matches_optax_over_10_steps():
    worst, opt, js, tp = _against_optax(
        lambda p: AmsGrad(p, lr=LR, betas=(0.9, 0.999), eps=1e-8))
    assert worst <= 1e-6, worst
    st = opt.state[tp]
    assert st['step'] == 10 and opt.steps == 10
    amsgrad_state = js[0]
    for name in ('mu', 'nu', 'nu_max'):
        np.testing.assert_allclose(st[name].numpy(),
                                   np.asarray(getattr(amsgrad_state, name)),
                                   rtol=1e-5, atol=1e-12)


def test_torch_adam_amsgrad_is_not_optax_amsgrad():
    """Regression: ``torch.optim.Adam(amsgrad=True)`` takes the maximum of
    the raw second moment, optax of the bias-corrected one; the same
    comparison fails by two orders of magnitude."""
    worst, *_ = _against_optax(
        lambda p: torch.optim.Adam(p, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                                   amsgrad=True))
    assert worst > 1e-4, worst


def test_amsgrad_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(4))
    opt = AmsGrad([p])
    for g in (1.0, -0.5):
        p.grad = torch.full((4,), g)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = AmsGrad([q])
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))
    for o, par in ((opt, p), (opt2, q)):
        par.grad = torch.full((4,), 0.25)
        o.step()
    assert torch.equal(p, q) and opt2.steps == 3


# ---------------------------------------------------------------------------
# BatchNorm in training mode
# ---------------------------------------------------------------------------

def test_batchnorm_training_matches_flax_at_n_202():
    """bn0's shape: 2 clips of 1 s (101 frames) x 64 mel bins in dB
    (mean -30, spread 6), so each bin's statistics see n = 202 values.

    Output within 1e-6 of a float64 evaluation, running mean and
    variance within rtol 1e-6 of it (flax's rule: 0.9 running + 0.1
    batch, biased variance).  Against flax itself: the running mean
    within rtol 1e-6; the output and the running variance within flax's
    own float32 error, measured here (flax computes the variance as
    E[x^2] - E[x]^2, which cancels at a -30 dB mean: ~1.5e-5 on the
    output, ~1e-4 relative on the variance).  torch's
    ``nn.BatchNorm1d`` moves the running variance toward n/(n-1) times
    the batch variance."""
    import flax.linen as fnn
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 101, 64) * 6 - 30).astype(np.float32)  # (B, T, F)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5, axis=2)
    xj = jnp.asarray(x[..., None])
    variables = flax_bn.init(jax.random.PRNGKey(0), xj)
    want, mutated = flax_bn.apply(variables, xj, mutable=['batch_stats'])
    stats = mutated['batch_stats']

    bn = blocks.BatchNorm(64).train()
    got = bn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    x64 = x.astype(np.float64)
    mean, var = x64.mean(axis=(0, 1)), x64.var(axis=(0, 1))
    exact = (x64 - mean) / np.sqrt(var + 1e-5)
    want = np.asarray(want)[..., 0]
    flax_err = np.abs(want - exact).max()
    np.testing.assert_allclose(got.detach().numpy(), exact, atol=1e-6)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-6 + flax_err
    assert flax_err < 5e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats['mean']), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats['var']), rtol=5e-4)
    plain = torch.nn.BatchNorm1d(64, eps=1e-5, momentum=0.1).train()
    plain(torch.from_numpy(x).transpose(1, 2))
    ratio = (plain.running_var - 0.9) / (bn.running_var - 0.9)
    np.testing.assert_allclose(ratio.numpy(), 202 / 201, rtol=1e-4)
    # eval mode is nn.BatchNorm's, bit for bit
    bn.eval()
    ref = torch.nn.BatchNorm1d(64, eps=1e-5, momentum=0.1).eval()
    ref.load_state_dict(bn.state_dict())
    xt = torch.from_numpy(x).transpose(1, 2)
    assert torch.equal(bn(xt), ref(xt))


# ---------------------------------------------------------------------------
# the joint train step against sed_tpu's
# ---------------------------------------------------------------------------

def _batches(seed=0, n_weak=4, n_strong=2, mixup=True):
    rng = np.random.RandomState(seed)
    sr = CFG.sample_rate
    weak = {'waveform': rng.uniform(-0.3, 0.3, (n_weak, sr))
            .astype(np.float32),
            'target': (rng.rand(n_weak, 25) > 0.7).astype(np.float32)}
    strong = {'waveform': rng.uniform(-0.3, 0.3, (n_strong, sr))
              .astype(np.float32),
              'strong_target': (rng.rand(n_strong, 100, 25) > 0.8)
              .astype(np.float32)}
    if mixup:
        for b in (weak, strong):
            lam = rng.rand(len(b['waveform']) // 2)
            b['mixup_lambda'] = np.stack([lam, 1 - lam], 1).reshape(-1) \
                .astype(np.float32)
    return weak, strong


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


class _NoDropout(jax_blocks.nn.Module):
    """flax ``nn.Dropout`` made inert for a test (sed_tpu is not edited)."""
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def _init(jm, seed=0):
    """flax init, jitted (op by op it takes several times longer)."""
    x = jnp.zeros((1, CFG.sample_rate))
    return jax.tree.map(np.asarray, dict(jax.jit(
        lambda k: jm.init({'params': k}, x, train=False))(
            jax.random.PRNGKey(seed))))


def _pair(temporal, monkeypatch):
    """(flax model, its init variables, port model loaded with them)."""
    if temporal == 'multihead':
        monkeypatch.setattr(jax_blocks.nn, 'Dropout', _NoDropout)
    jm = JaxCnnSed(cfg=CFG, temporal=temporal, **NARROW)
    variables = _init(jm)
    pm = CnnSed(CFG, temporal=temporal, **NARROW)
    load_variables(pm, variables)
    if temporal == 'multihead':
        pm.multihead.dropout_rate = pm.multihead.attn_dropout_rate = 0.0
    return jm, variables, pm


def _port_gradients(pm, weak, strong, dtype=torch.float32):
    """One joint step's gradients without the update (float64 runs the
    whole model and frontend in float64)."""
    import sed_tpu_torch.dsp.frontend as fe
    pm = pm.to(dtype)
    state = create_train_state(pm, LR, fresh=False)
    state.optimizer.step = lambda *a: None
    step = make_train_step(pm, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=False,
                           spec_augment=False)
    cast = lambda b: {k: v.to(dtype) if k == 'waveform' else v  # noqa
                      for k, v in _t(b).items()}
    if dtype == torch.float32:
        metrics = step(cast(weak), [cast(strong)], torch.Generator())
    else:
        from unittest import mock

        def logmel64(wav, cfg):
            stft, mel = fe.frontend_matrices(cfg, wav.device)
            spec = fe.spectrogram(wav, stft.double(), cfg.hop_size,
                                  center=cfg.center, pad_mode=cfg.pad_mode)
            return fe.power_to_db(spec @ mel.double(), ref=cfg.ref,
                                  amin=cfg.amin)
        with mock.patch('sed_tpu_torch.ops.logmel_kernel.logmel_plain',
                        logmel64), \
                mock.patch('sed_tpu_torch.ops.wire.dequant_wire',
                           lambda w, s=None: w):
            metrics = step(cast(weak), [cast(strong)], torch.Generator())
    return ({k: p.grad.double() for k, p in pm.named_parameters()},
            metrics['loss'].item())


@pytest.fixture(scope='module', params=['gru', 'multihead'])
def joint_run(request):
    """Three joint steps (mixup on, SpecAugment and timeshift off) of the
    narrow model on both sides from the same weights and batches, with
    each side's gradients at the first step: the port's ``p.grad``, and
    sed_tpu's from AMSGrad's first moment (mu = 0.1 g after one step, one
    float32 rounding from g)."""
    with pytest.MonkeyPatch.context() as mp:
        jm, variables, pm = _pair(request.param, mp)
        weak, strong = _batches()
        jstate = SedTrainState.create(
            apply_fn=jm.apply, params=variables['params'],
            batch_stats=variables['batch_stats'],
            tx=optax.amsgrad(LR, b1=0.9, b2=0.999, eps=1e-8))
        jstep = jax_make_train_step(jm, jax_losses.clip_bce,
                                    jax_losses.frame_bce, mixup=True,
                                    timeshift=False, spec_augment=False,
                                    donate=False)
        state = create_train_state(pm, LR, fresh=False)
        step = make_train_step(pm, state.optimizer, losses.clip_bce,
                               losses.frame_bce, mixup=True,
                               timeshift=False, spec_augment=False)
        run = {'temporal': request.param, 'variables': variables,
               'batches': (weak, strong), 'metrics': []}
        for i in range(3):
            jstate, jmetrics = jstep(jstate, weak, strong,
                                     jax.random.PRNGKey(i))
            m = step(_t(weak), [_t(strong)],
                     torch.Generator().manual_seed(i))
            run['metrics'].append(({k: v.item() for k, v in m.items()},
                                   {k: float(v) for k, v in
                                    jmetrics.items()}))
            if i == 0:
                mu = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
                run['jax_grad'] = {
                    k: v.double() / float(np.float32(0.1)) for k, v in
                    state_dict_from_variables({'params': mu}).items()}
                run['grad'] = {k: p.grad.double().clone()
                               for k, p in pm.named_parameters()}
    run.update(jstate=jstate, state=state, pm=pm)
    return run


def test_one_joint_step_gradients_match_sed_tpu(joint_run):
    """One joint step (mixup on, SpecAugment and timeshift off): loss
    within rtol 1e-5 of sed_tpu's; each gradient within 1e-4 of its
    tensor's max |g| of sed_tpu's, once sed_tpu's own float32 error is
    allowed for, and within 1e-5 of a float64 evaluation of the same
    step (the port run in float64, frontend included).

    sed_tpu's own error is measured against that float64 gradient: here
    up to ~1e-5 of max |g|; on other batches its first blocks (bn0,
    conv_block1) reach ~1e-2 (in part flax's fast variance, E[x^2] -
    E[x]^2, whose backward cancels), the port's stay under 1e-5.  Both
    sides carry a float32 noise floor of ~1e-7 of the model's largest
    gradient (measured, att_block.att.bias), which the test allows as
    2e-7 of it: it decides tensors whose gradients are that small, such
    as att.bias and the Transformer's w_ks.bias, whose exact gradients
    vanish (a softmax does not see a shift common to all its inputs)."""
    temporal = joint_run['temporal']
    grad, jgrad = joint_run['grad'], joint_run['jax_grad']
    loss, jloss = (m['loss'] for m in joint_run['metrics'][0])
    pm64 = CnnSed(CFG, temporal=temporal, **NARROW)
    load_variables(pm64, joint_run['variables'])
    if temporal == 'multihead':
        pm64.multihead.dropout_rate = pm64.multihead.attn_dropout_rate = 0.0
    exact, _ = _port_gradients(pm64, *joint_run['batches'], torch.float64)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert grad.keys() == jgrad.keys()
    top = max(v.abs().max() for v in exact.values())
    floor = 2e-7 * top
    for k, g in grad.items():
        j = jgrad[k]
        scale = exact[k].abs().max()
        assert (g - exact[k]).abs().max() <= 1e-5 * scale + floor, k
        own = (j - exact[k]).abs().max()
        assert own <= 2e-2 * scale + floor, k
        assert (g - j).abs().max() <= 1e-4 * scale + floor + own, k


def _flat_state(pm):
    return {k: v.detach().double() for k, v in pm.state_dict().items()
            if not k.endswith('num_batches_tracked')}


def test_three_joint_steps_match_sed_tpu(joint_run):
    """Three steps, the same batches: losses within rtol 1e-5, and the
    state after them against sed_tpu's at lr 1e-3.

    AMSGrad's first update is ~lr * sign(g), so an element whose gradient
    is within the float32 noise of either side (the floor of the
    one-step test above; att.bias's exact 0) moves by up to 2 lr the
    other way, and steps 2 and 3 then see slightly different parameters.
    So the test does not hold every element to 1e-5, as it would for an
    SGD step.  Measured, the larger of GRU and Transformer: parameters
    max 1.2e-3, mean 1.6e-6, 2.6% of the elements beyond 1e-5; BatchNorm
    buffers 1.9e-5 (relative, or absolute under 1); the moments mu, nu,
    nu_max 1.8e-2, 1.5e-2, 8.8e-3 of each tensor's scale (plus 1e-3 of
    the model's largest).  It holds: parameters max < 3 steps x 2 lr,
    mean < 1e-5, under 5% beyond 1e-5; buffers 5e-5; moments 0.1."""
    for m, jm_ in joint_run['metrics']:
        for key in ('loss', 'weak_loss', 'strong_loss'):
            assert abs(m[key] - jm_[key]) <= 1e-5 * abs(jm_[key])
    jstate, state, pm = (joint_run[k] for k in ('jstate', 'state', 'pm'))
    assert state.step == int(jstate.step) == 3
    want = _flat_state_of(jstate)
    got = _flat_state(pm)
    diffs, bn_worst = [], 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        if 'running' in k:
            bn_worst = max(bn_worst, (d / w.abs().clamp_min(1.0)).max().item())
            continue
        diffs.append(d.reshape(-1))
    d = torch.cat(diffs)
    stats = (d.max().item(), d.mean().item(), (d > 1e-5).double().mean().item())
    # AMSGrad's moments, each tensor against its scale, with a floor of
    # 1e-3 of the model's largest moment (the noise floor of the
    # gradients above, accumulated)
    moments = jax.tree.map(np.asarray, jstate.opt_state[0])
    worst = {}
    for name in ('mu', 'nu', 'nu_max'):
        want_m = state_dict_from_variables(
            {'params': getattr(moments, name)})
        top = max(np.abs(v).max() for v in want_m.values())
        for k, p in pm.named_parameters():
            got_m = state.optimizer.state[p][name].double()
            w = want_m[k].double()
            rel = ((got_m - w).abs().max()
                   / (w.abs().max() + 1e-3 * top)).item()
            worst[name] = max(worst.get(name, 0.0), rel)
    measured = (stats, bn_worst, worst)
    assert bn_worst < 5e-5, measured
    assert d.max() < 3 * 2 * LR and d.mean() < 1e-5, measured
    assert (d > 1e-5).double().mean() < 0.05, measured
    assert max(worst.values()) < 0.1, measured


def _flat_state_of(jstate):
    return {k: v.double() for k, v in state_dict_from_variables(
        {'params': jax.tree.map(np.asarray, jstate.params),
         'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)}
    ).items() if not k.endswith('num_batches_tracked')}


# ---------------------------------------------------------------------------
# loss scaling
# ---------------------------------------------------------------------------

def _port_state(seed=0):
    pm = CnnSed(CFG, temporal='none', head='avg',
                conv_channels=(8, 16, 16, 32))
    return create_train_state(pm, LR, torch.Generator().manual_seed(seed))


def _scaled(state, loss_scale):
    return make_train_step(state.model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=False, timeshift=False,
                           spec_augment=False, loss_scale=loss_scale)


def test_static_loss_scale_equals_the_unscaled_step():
    """A power-of-two scale is exact in float32: loss, parameters and
    BatchNorm buffers bitwise equal to the unscaled step's after 3 steps
    (sed_tpu's two programs compile to different fusions and agree only
    to reassociation noise, ``tests/test_train_extra.py:109-146``)."""
    weak, strong = _batches(seed=3, mixup=False)
    a, b = _port_state(), _port_state()
    plain = make_train_step(a.model, a.optimizer, losses.clip_bce,
                            losses.frame_bce, mixup=False, timeshift=False,
                            spec_augment=False)
    scaled = _scaled(b, 1024.0)
    for _ in range(3):
        m0 = plain(_t(weak), _t(strong), torch.Generator())
        m1 = scaled(_t(weak), _t(strong), torch.Generator())
        assert m1['grads_finite'] and m1['loss_scale'] == 1024.0
        assert m0['loss'].item() == m1['loss'].item()
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert a.step == b.step == 3


@pytest.mark.parametrize('loss_scale', ['dynamic', 4096.0])
def test_nonfinite_step_is_skipped_like_sed_tpu(loss_scale):
    """An ``inf`` in the batch: parameters, optimizer state, step and
    BatchNorm buffers bit-identical to before; the dynamic scale halves
    and its counter resets, as sed_tpu's (``tests/test_train_extra.py:
    149-191``); the next clean step applies."""
    weak, strong = _batches(seed=5, mixup=False)
    state = _port_state()
    step = _scaled(state, loss_scale)
    dynamic = loss_scale == 'dynamic'

    def run(w, ss):
        out = step(_t(w), _t(strong), torch.Generator(), *(
            (ss,) if dynamic else ()))
        return out if dynamic else (out, ss)

    ss = init_loss_scale()
    m, ss = run(weak, ss)
    assert m['grads_finite'] and state.step == 1
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in
                  state.optimizer.state[next(state.model.parameters())]
                  .items() if torch.is_tensor(v)}
    bad = dict(weak)
    bad['waveform'] = weak['waveform'].copy()
    bad['waveform'][0, 0] = np.inf
    m, ss2 = run(bad, ss)
    assert not m['grads_finite'] and state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in opt_before.items():
        assert torch.equal(state.optimizer.state[
            next(state.model.parameters())][k], v)
    if dynamic:
        assert ss2 == LossScaleState(ss.scale * 0.5, 0)
        assert m['loss_scale'] == ss.scale * 0.5
    m, _ = run(weak, ss2)
    assert m['grads_finite'] and state.step == 2


def test_dynamic_scale_grows_after_the_interval_and_is_capped():
    weak, strong = _batches(seed=6, mixup=False)
    state = _port_state()
    step = _scaled(state, 'dynamic')
    _, ss = step(_t(weak), _t(strong), torch.Generator(),
                 LossScaleState(1024.0, _GROWTH_INTERVAL - 1))
    assert ss == LossScaleState(2048.0, 0)
    _, ss = step(_t(weak), _t(strong), torch.Generator(),
                 LossScaleState(2.0 ** 15, _GROWTH_INTERVAL - 1))
    assert ss == LossScaleState(2.0 ** 15, 0)
    # sed_tpu's state type carries the same two fields
    assert JaxLossScaleState._fields == LossScaleState._fields


def test_dynamic_scaled_step_matches_sed_tpu_loss():
    """The dynamic scaled step's loss against sed_tpu's dynamic scaled
    step from the same weights (rtol 1e-5), the scale unchanged."""
    from sed_tpu.train.step import init_loss_scale as jax_init_loss_scale
    jm = JaxCnnSed(cfg=CFG, temporal='none', head='avg',
                   conv_channels=(8, 16, 16, 32))
    variables = _init(jm, seed=1)
    weak, strong = _batches(seed=7, mixup=False)
    jstate = SedTrainState.create(
        apply_fn=jm.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.amsgrad(LR, b1=0.9, b2=0.999, eps=1e-8))
    jstep = jax_make_train_step(jm, jax_losses.clip_bce,
                                jax_losses.frame_bce, mixup=False,
                                timeshift=False, spec_augment=False,
                                donate=False, loss_scale='dynamic')
    _, jm_, jss = jstep(jstate, weak, strong, jax.random.PRNGKey(0),
                        jax_init_loss_scale())
    pm = CnnSed(CFG, temporal='none', head='avg',
                conv_channels=(8, 16, 16, 32))
    load_variables(pm, variables)
    state = create_train_state(pm, LR, fresh=False)
    m, ss = _scaled(state, 'dynamic')(_t(weak), _t(strong),
                                      torch.Generator(), init_loss_scale())
    assert abs(m['loss'].item() - float(jm_['loss'])) <= \
        1e-5 * float(jm_['loss'])
    assert ss.scale == float(jss.scale) and ss.good_steps == \
        int(jss.good_steps) == 1


# ---------------------------------------------------------------------------
# fresh initialisation, modes, checkpoints, prefetch
# ---------------------------------------------------------------------------

def test_fresh_init_follows_sed_tpu_distributions():
    """Full width Cnn_9layers_Gru_FrameAtt and a Transformer with conv
    channels 32/64/64/128 (a MultiHead over d_model 128): each
    initialiser's spread within 5% of sed_tpu's (the flax init's, same
    shapes), zero biases, an orthogonal n gate, BatchNorm at 1/0."""
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu_torch.models.registry import get_model
    for name, kw in (('Cnn_9layers_Gru_FrameAtt', {}),
                     ('Cnn_9layers_Transformer_FrameAtt',
                      dict(conv_channels=(32, 64, 64, 128)))):
        pm = get_model(name, CFG, **kw)
        blocks.init_weights(pm, torch.Generator().manual_seed(0))
        ref = state_dict_from_variables(_init(jax_get_model(name, CFG,
                                                            **kw)))
        got = pm.state_dict()
        for k, w in ref.items():
            g = got[k].double()
            if k.endswith('num_batches_tracked'):
                continue
            if w.abs().max() == 0 or k.endswith(('running_mean',
                                                 'running_var')) \
                    or '.bn' in k or k.startswith('bn0.'):
                assert torch.equal(g, w.double()), k
                continue
            assert abs(g.std() / w.double().std() - 1) < 0.05, k
            assert abs(g.abs().max() / w.double().abs().max() - 1) < 0.2, k
        h = 256
        for suffix in ('', '_reverse') if 'Gru' in name else ():
            n = got['gru.weight_hh_l0' + suffix][2 * h:].double()
            assert torch.allclose(n @ n.T, torch.eye(h, dtype=n.dtype),
                                  atol=1e-5)


def test_evaluator_restores_the_models_mode():
    """The Evaluator runs the model in eval mode and gives it back in the
    mode it had: a train loop that evaluates keeps training."""
    from sed_tpu_torch.eval.evaluator import Evaluator
    pm = CnnSed(CFG, temporal='gru', **NARROW)
    blocks.init_weights(pm, torch.Generator().manual_seed(0))
    wav = np.random.RandomState(0).uniform(-0.3, 0.3, (2, 16000)) \
        .astype(np.float32)
    loader = [{'audio_name': np.array(['a', 'b']), 'waveform': wav}]
    ev = Evaluator(pm.train(), 'cpu')
    assert pm.training
    buffers = {k: v.clone() for k, v in pm.state_dict().items()}
    out = ev.forward(loader)
    assert pm.training                            # restored
    for k, v in pm.state_dict().items():          # eval-mode forward
        assert torch.equal(v, buffers[k]), k
    want = pm.eval()(torch.from_numpy(wav))['framewise_output']
    np.testing.assert_array_equal(out['framewise_output'], want.detach())
    ev.forward(loader)
    assert not pm.training


def test_checkpoint_lineage_round_trip(tmp_path):
    """``iter_<N>.pth`` + ``BEST``; restore gives the model, optimizer and
    step; resume at an unsaved N lists the saved ones; the file is the
    reference layout that sed_tpu's numpy loader reads."""
    from sed_tpu.compat.torch_loader import load_checkpoint_variables
    weak, strong = _batches(seed=8, mixup=False)
    state = _port_state()
    step = make_train_step(state.model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=False, timeshift=False,
                           spec_augment=False)
    d = str(tmp_path / 'best_logmel_16k')
    assert ckpt.best_checkpoint_path(d) is None
    for i in range(3):
        step(_t(weak), _t(strong), torch.Generator())
        if i != 1:
            ckpt.save_best_checkpoint(d, state)
    assert ckpt.saved_iterations(d) == [1, 3]
    assert ckpt.best_checkpoint_path(d).endswith('iter_3.pth')
    os.remove(os.path.join(d, 'BEST'))
    assert ckpt.best_checkpoint_path(d).endswith('iter_3.pth')
    with pytest.raises(FileNotFoundError, match=r'saved iterations: \[1, 3\]'):
        ckpt.resume_checkpoint_path(d, 2)

    fresh = _port_state(seed=9)
    ckpt.restore_checkpoint(ckpt.resume_checkpoint_path(d, 3), fresh)
    assert fresh.step == 3
    for (k, v), w in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(v, w), k
    p, q = (next(s.model.parameters()) for s in (state, fresh))
    assert torch.equal(state.optimizer.state[p]['nu_max'],
                       fresh.optimizer.state[q]['nu_max'])

    variables, iteration = load_checkpoint_variables(
        ckpt.resume_checkpoint_path(d, 3))
    assert iteration == 3
    back = state_dict_from_variables(variables)
    for k, v in back.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, state.model.state_dict()[k]), k


def test_device_prefetch_order_errors_and_abandon():
    """In order, as tensors; a producer exception re-raises at next();
    closing the generator stops the producer's draws."""
    import time
    items = [{'a': np.full((4,), i, np.float32)} for i in range(10)]
    out = list(device_prefetch(iter(items), size=2, device='cpu'))
    assert [int(o['a'][0]) for o in out] == list(range(10))
    assert all(isinstance(o['a'], torch.Tensor) for o in out)

    def bad():
        yield items[0]
        raise ValueError('boom')

    it = device_prefetch(bad(), size=2, device='cpu')
    next(it)
    with pytest.raises(ValueError, match='boom'):
        next(it)

    drawn = [0]

    def src():
        while True:
            drawn[0] += 1
            yield {'a': np.zeros((2,), np.float32)}

    it = device_prefetch(src(), size=2, device='cpu')
    next(it)
    it.close()
    time.sleep(0.6)
    n = drawn[0]
    time.sleep(0.6)
    assert drawn[0] == n


def test_training_forward_runs_the_augmentations_from_the_generator():
    """SpecAugment + mixup + timeshift in training mode: the same
    generator seed gives the same output, another seed another; the
    batch halves; eval mode ignores the flags."""
    pm = CnnSed(CFG, temporal='multihead', **NARROW)
    blocks.init_weights(pm, torch.Generator().manual_seed(0))
    wav = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.3, 0.3, (4, 16000)).astype(np.float32))
    lam = torch.tensor([0.3, 0.7, 0.6, 0.4])
    kw = dict(mixup_lambda=lam, timeshift=True, spec_augment=True)
    pm.train()
    a = pm(wav, generator=torch.Generator().manual_seed(1), **kw)
    b = pm(wav, generator=torch.Generator().manual_seed(1), **kw)
    c = pm(wav, generator=torch.Generator().manual_seed(2), **kw)
    assert a['clipwise_output'].shape == (2, 25)
    assert torch.equal(a['framewise_output'], b['framewise_output'])
    assert not torch.equal(a['framewise_output'], c['framewise_output'])
    pm.eval()
    e1 = pm(wav, generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(e1['framewise_output'], pm(wav)['framewise_output'])


def test_eval_step_is_the_eval_forward_and_restores_the_mode():
    from sed_tpu_torch.train.step import make_eval_step
    pm = CnnSed(CFG, temporal='gru', **NARROW)
    blocks.init_weights(pm, torch.Generator().manual_seed(0))
    pcm = (np.random.RandomState(0).uniform(-0.3, 0.3, (2, 16000))
           * 32767).astype(np.int16)
    pm.train()
    out = make_eval_step(pm)(torch.from_numpy(pcm))
    assert pm.training
    with torch.no_grad():
        want = pm.eval()(torch.from_numpy(pcm).float() / 32767.0)
    assert torch.equal(out['framewise_output'], want['framewise_output'])
