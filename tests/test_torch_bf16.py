"""sed_tpu_torch's bf16 conv stack (``compute_dtype``) against ``sed_tpu``'s.

Both packages round the same operands to bf16 (each convolution's input
and weight, and its output before the float32 BatchNorm) and accumulate
in float32; they differ by the order of the sums and by which outputs
fall on the other side of a bf16 rounding.  Measured here on the CPU
(oneDNN for torch, XLA for JAX), Cnn_9layers_Gru_FrameAtt on the trained
bench checkpoint, 4 bench-corpus clips of 5 s: port bf16 - sed_tpu bf16
5.5e-4 framewise, 2.4e-4 clipwise, where each is 2.5e-3 from its own
float32 output (float32 port - sed_tpu: 4.3e-7).  The tests hold the two
bf16 models to 2e-3.

Gradients: bf16 rounding before a training-mode BatchNorm makes one
joint step's gradient of the narrow model ~10-13% (relative L2) off its
float32 gradient on BOTH sides, and the two packages' bf16 gradients are
as far apart (the rounding noise is not shared: it flips at other
elements), so the per-tensor bounds of ``tests/test_torch_train.py``'s
float32 step cannot hold; the bf16 step test holds the loss, the size
of each side's bf16 error and the distance of the two bf16 gradients.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from sed_tpu import losses as jax_losses
from sed_tpu.config import AUDIO_16K
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.models.zoo import CnnSed as JaxCnnSed
from sed_tpu.train.state import SedTrainState
from sed_tpu.train.step import make_train_step as jax_make_train_step
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch import losses
from sed_tpu_torch.compat.from_flax import (load_npz, load_variables,
                                            state_dict_from_variables)
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.serve.engine import SedInferenceEngine
from sed_tpu_torch.train.state import create_train_state
from sed_tpu_torch.train.step import init_loss_scale, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402

CFG = AUDIO_16K
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
BF16_ATOL = 2e-3            # port bf16 - sed_tpu bf16 (measured 5.5e-4)
NARROW = dict(conv_channels=(8, 16, 16, 32), head='att', gru_hidden=16,
              pad_to_roundup=True)
LR = 1e-3


def _outputs(model, wav):
    with torch.no_grad():
        out = model(torch.from_numpy(wav))
    return {k: out[k].numpy() for k in ('framewise_output',
                                        'clipwise_output')}


def test_conv_block_rounds_where_sed_tpu_rounds():
    """A bf16 ConvBlock is ``conv(x.bf16, w.bf16)`` rounded to bf16 and
    cast to float32 before each float32 BatchNorm, bit for bit; its
    parameters and buffers (and so ``state_dict``) are the float32
    block's, keys and dtypes."""
    torch.manual_seed(0)
    f32 = blocks.ConvBlock(3, 8).train()
    b16 = blocks.ConvBlock(3, 8, dtype=torch.bfloat16).train()
    b16.load_state_dict(f32.state_dict())
    x = torch.randn(2, 3, 16, 12)
    got = b16(x)

    def conv(c, v):
        return torch.nn.functional.conv2d(
            v.bfloat16(), c.weight.bfloat16(), padding=1).float()

    ref = blocks.ConvBlock(3, 8).train()
    ref.load_state_dict(f32.state_dict())
    h = torch.relu(ref.bn1(conv(ref.conv1, x)))
    h = torch.relu(ref.bn2(conv(ref.conv2, h)))
    want = torch.nn.functional.avg_pool2d(h, (2, 2))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert {k: (v.dtype, v.shape) for k, v in b16.state_dict().items()} == \
        {k: (v.dtype, v.shape) for k, v in f32.state_dict().items()}
    assert not torch.equal(got, f32(x))


def test_bf16_compute_dtype_close_to_f32():
    """``tests/test_models.py:175``: a fresh Cnn_9layers_Gru_FrameAtt on a
    2 s clip, bf16 conv stack against float32: clipwise within 0.05, the
    output float32; the model's ``state_dict`` is the float32 model's."""
    wav = np.random.RandomState(0).uniform(
        -0.3, 0.3, (1, CFG.sample_rate * 2)).astype(np.float32)
    f32 = get_model(MODEL, CFG)
    blocks.init_weights(f32, torch.Generator().manual_seed(0))
    b16 = get_model(MODEL, CFG, compute_dtype=torch.bfloat16)
    b16.load_state_dict(f32.state_dict())
    a, b = _outputs(f32, wav), _outputs(b16, wav)
    assert b['framewise_output'].dtype == np.float32
    np.testing.assert_allclose(b['clipwise_output'], a['clipwise_output'],
                               atol=0.05)
    assert b16.compute_dtype is torch.bfloat16
    assert {k: v.dtype for k, v in b16.state_dict().items()} == \
        {k: v.dtype for k, v in f32.state_dict().items()}


def test_bf16_matches_sed_tpu_bf16_on_the_same_weights():
    """The bench checkpoint through ``compat/from_flax``, 4 clips of 5 s:
    the port's bf16 model within ``BF16_ATOL`` (2e-3) of ``sed_tpu``'s
    bf16 model, framewise and clipwise; the float32 pair within 1e-5;
    each bf16 model further from its own float32 output than from the
    other package's bf16 one (they round alike)."""
    variables = load_variables_npz(CKPT)
    wav = make_clips(4, CFG.sample_rate, seconds=5, seed=5).astype(
        np.float32)
    got, want = {}, {}
    for tag, td, jd in (('f32', None, None),
                        ('bf16', torch.bfloat16, jnp.bfloat16)):
        jm = jax_get_model(MODEL, CFG, compute_dtype=jd)
        jo = jax.jit(lambda v, w: jm.apply(v, w, train=False))(
            variables, jnp.asarray(wav))
        want[tag] = {k: np.asarray(jo[k]) for k in ('framewise_output',
                                                    'clipwise_output')}
        got[tag] = _outputs(load_npz(CKPT, MODEL, CFG, 'cpu',
                                     compute_dtype=td), wav)
    for k in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got['f32'][k], want['f32'][k], atol=1e-5)
        pair = np.abs(got['bf16'][k] - want['bf16'][k]).max()
        own = np.abs(got['bf16'][k] - got['f32'][k]).max()
        assert pair <= BF16_ATOL, (k, pair)
        assert pair < own, (k, pair, own)


def test_bf16_serving_events_match_f32():
    """``tests/test_serve.py:796``: the bench checkpoint served with a
    bf16 conv stack against float32 on 8 int16 clips of 5 s: framewise
    within 0.05; events (label, onset and offset within 0.05 s) matched
    both ways for at least 90%."""
    clips = make_clips(8, CFG.sample_rate, seconds=5, seed=5)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    engines = {tag: SedInferenceEngine(
        load_npz(CKPT, MODEL, CFG, 'cpu', compute_dtype=dtype), CFG, 'cpu',
        sample_duration=5, overlap=True, batch_size=8)
        for tag, dtype in (('f32', None), ('bf16', torch.bfloat16))}
    fa, _ = engines['f32'].infer_framewise(pcm)
    fb, _ = engines['bf16'].infer_framewise(pcm)
    assert np.abs(fa - fb).max() < 0.05
    ea, _ = engines['f32'].predict_clips(pcm)
    eb, _ = engines['bf16'].predict_clips(pcm)

    def flat(per_clip):
        return {(i, e['event_label'], round(e['onset'], 2),
                 round(e['offset'], 2))
                for i, evs in enumerate(per_clip) for e in evs}

    def matched(src, dst):
        return sum(any(i == j and lb == lb2 and abs(on - on2) <= 0.05
                       and abs(off - off2) <= 0.05
                       for (j, lb2, on2, off2) in dst)
                   for (i, lb, on, off) in src)

    a, b = flat(ea), flat(eb)
    total = max(len(a), len(b), 1)
    assert len(a) > 0                     # the trained model finds events
    assert matched(a, b) + matched(b, a) >= 2 * 0.9 * total, (a, b)


def test_bf16_transformer_trains_finite_with_dynamic_scale():
    """``tests/test_train_extra.py:215``: Cnn_9layers_Transformer_FrameAtt
    with a bf16 conv stack (conv channels 8/16/16/32, a MultiHead over
    d_model 32, to keep the CPU's bf16 convolutions short), 3
    dynamically loss-scaled steps (SpecAugment and dropout on): every
    loss finite or its step skipped, the parameters finite and float32,
    at least one step."""
    rng = np.random.RandomState(9)
    sr = CFG.sample_rate
    weak = {'waveform': torch.from_numpy(rng.uniform(
                -0.1, 0.1, (2, sr)).astype(np.float32)),
            'target': torch.from_numpy(
                (rng.rand(2, 25) > 0.8).astype(np.float32))}
    strong = {'waveform': torch.from_numpy(rng.uniform(
                  -0.1, 0.1, (2, sr)).astype(np.float32)),
              'strong_target': torch.from_numpy(
                  (rng.rand(2, 100, 25) > 0.9).astype(np.float32))}
    model = get_model('Cnn_9layers_Transformer_FrameAtt', CFG,
                      conv_channels=NARROW['conv_channels'],
                      compute_dtype=torch.bfloat16)
    state = create_train_state(model, LR, torch.Generator().manual_seed(0))
    step = make_train_step(model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=False, timeshift=False,
                           spec_augment=True, loss_scale='dynamic')
    ss = init_loss_scale()
    gen = torch.Generator().manual_seed(21)
    for _ in range(3):
        m, ss = step(weak, strong, gen, ss)
        assert np.isfinite(m['loss'].item()) or not m['grads_finite']
    assert all(torch.isfinite(p).all() and p.dtype == torch.float32
               for p in model.parameters())
    assert state.step >= 1


def test_families_store_compute_dtype_and_keep_float32_convs(caplog):
    """As in ``sed_tpu``, only the ``CnnSed`` names run their convolutions
    in ``compute_dtype``; the other families store it, log once that
    their convolutions stay float32, and compute as in float32."""
    import logging
    names = sorted(MODEL_REGISTRY)
    with caplog.at_level(logging.INFO):
        models = {n: get_model(n, CFG, compute_dtype=torch.bfloat16)
                  for n in names}
    for name, m in models.items():
        assert m.compute_dtype is torch.bfloat16
        bf16_convs = [c for c in m.modules()
                      if getattr(c, 'compute_dtype', None) is torch.bfloat16
                      and isinstance(c, torch.nn.Conv2d)]
        if isinstance(m, CnnSed):
            assert bf16_convs, name
        else:
            assert not bf16_convs, name
            assert sum(type(m).__name__ in r.getMessage()
                       and 'float32' in r.getMessage()
                       for r in caplog.records) >= 1, name
    assert sum(isinstance(m, CnnSed) for m in models.values()) == 10


def _batches(seed):
    rng = np.random.RandomState(seed)
    sr = CFG.sample_rate
    weak = {'waveform': rng.uniform(-0.3, 0.3, (4, sr)).astype(np.float32),
            'target': (rng.rand(4, 25) > 0.7).astype(np.float32)}
    strong = {'waveform': rng.uniform(-0.3, 0.3, (2, sr)).astype(np.float32),
              'strong_target': (rng.rand(2, 100, 25) > 0.8)
              .astype(np.float32)}
    for b in (weak, strong):
        lam = rng.rand(len(b['waveform']) // 2)
        b['mixup_lambda'] = np.stack([lam, 1 - lam], 1).reshape(-1) \
            .astype(np.float32)
    return weak, strong


def _jax_step(variables, weak, strong):
    """One joint step of ``sed_tpu``'s bf16 narrow model (mixup on,
    SpecAugment and timeshift off): its loss, and its gradient from
    AMSGrad's first moment."""
    jm = JaxCnnSed(cfg=CFG, temporal='gru', compute_dtype=jnp.bfloat16,
                   **NARROW)
    jstate = SedTrainState.create(
        apply_fn=jm.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.amsgrad(LR, b1=0.9, b2=0.999, eps=1e-8))
    jstep = jax_make_train_step(jm, jax_losses.clip_bce,
                                jax_losses.frame_bce, mixup=True,
                                timeshift=False, spec_augment=False,
                                donate=False)
    jstate, jmetrics = jstep(jstate, weak, strong, jax.random.PRNGKey(0))
    mu = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    return float(jmetrics['loss']), {
        k: v.double() / float(np.float32(0.1))
        for k, v in state_dict_from_variables({'params': mu}).items()}


def _port_step(variables, weak, strong, dtype):
    """The same step of the port's narrow model in ``dtype``."""
    pm = CnnSed(CFG, temporal='gru', compute_dtype=dtype, **NARROW)
    load_variables(pm, variables)
    state = create_train_state(pm, LR, fresh=False)
    step = make_train_step(pm, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=False,
                           spec_augment=False)
    t = {k: torch.from_numpy(v.copy()) for k, v in weak.items()}
    s = {k: torch.from_numpy(v.copy()) for k, v in strong.items()}
    m = step(t, [s], torch.Generator())
    return m['loss'].item(), {k: p.grad.double()
                              for k, p in pm.named_parameters()}


def _rel_l2(a: dict, b: dict) -> float:
    return (sum(((a[k] - b[k]) ** 2).sum() for k in b)
            / sum((b[k] ** 2).sum() for k in b)).sqrt().item()


def test_one_joint_bf16_step_against_sed_tpu():
    """One joint step of the narrow GRU model from the same weights and
    batch, bf16 conv stack on both sides.  Loss within rtol 2e-4 of
    sed_tpu's (measured 1.7e-5 to 4.6e-5 on three batches).  Gradients,
    relative L2 over the whole model, against the port's float32 gradient
    (itself within 1e-5 of sed_tpu's float32 one,
    ``tests/test_torch_train.py``): each side's bf16 gradient off it by
    0.05-0.25 (measured 0.096-0.127), the port's within 0.5x-2x of
    sed_tpu's, and the two bf16 gradients within 0.2 of each other
    (measured 0.105-0.138).  The weak batch of 4 mixes into 2 rows and
    the strong one into 1, so each training-mode BatchNorm's backward
    (the gradient less its mean and its projection on the normalised
    input) cancels over few elements and magnifies the bf16 rounding."""
    jm = JaxCnnSed(cfg=CFG, temporal='gru', **NARROW)
    variables = jax.tree.map(np.asarray, dict(jax.jit(
        lambda k: jm.init({'params': k}, jnp.zeros((1, CFG.sample_rate)),
                          train=False))(jax.random.PRNGKey(0))))
    weak, strong = _batches(1)
    jl, jg = _jax_step(variables, weak, strong)
    pl32, pg32 = _port_step(variables, weak, strong, None)
    pl, pg = _port_step(variables, weak, strong, torch.bfloat16)
    assert abs(pl - jl) <= 2e-4 * jl, (pl, jl)
    port_err, jax_err = _rel_l2(pg, pg32), _rel_l2(jg, pg32)
    assert 0.05 <= port_err <= 0.25 and 0.05 <= jax_err <= 0.25, \
        (port_err, jax_err)
    assert 0.5 <= port_err / jax_err <= 2.0, (port_err, jax_err)
    assert _rel_l2(pg, jg) <= 0.2
