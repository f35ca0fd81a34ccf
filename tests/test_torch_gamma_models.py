"""Every registry name of sed_tpu_torch with ``feature_type='gamma'``
against ``sed_tpu``: eval and training-mode forwards on packed gammatone
features, frame counts included (CNN14 pads to ``T - 1``; the others
keep what their pooling and interpolation give).

Inputs: two bench-corpus clips of 16 kHz packed as gammatone features
(``fft_gtgram_db(...).astype(np.int16) / 32767``, the HDF5 path's
values), cut to T = 200 frames.  Weights: the port's ``init_weights``
from a generator seeded by the name, written in the reference's
``.pth`` layout and read by ``sed_tpu.compat.torch_loader`` into flax
variables, whose 1-D leaves are moved off their init
(``test_torch_families.perturb``) and whose ``bn0`` statistics are the
features' per-bin moments (a trained model's, so that ``bn0`` does not
flatten the 1e-3-sized inputs); the port's model is then loaded from
those variables by ``compat/from_flax.load_variables`` (strict).  The
log-mel frontend is never called.

Tolerances, those of ``tests/test_torch_families.py``: eval outputs
``rtol 1e-5 + atol 2e-5``; training-mode outputs ``rtol 1e-4 + atol
1e-4``; BatchNorm buffers after a training forward 5e-5, relative above
1.
"""

import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu import config as jax_config
from sed_tpu.compat import torch_loader as jax_loader
from sed_tpu.models import blocks as jax_blocks
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu_torch import config
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.compat import from_flax
from sed_tpu_torch.dsp import gammatone as gt
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.registry import MODEL_REGISTRY, get_model

from test_torch_families import perturb, zero_dropouts
from test_torch_train import _NoDropout

CFG = config.AUDIO_16K
T = 200
NAMES = sorted(MODEL_REGISTRY)
KEYS = ('framewise_output', 'clipwise_output', 'embedding')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def feats():
    clips = make_clips(2, CFG.sample_rate, seconds=3, seed=17)
    packed = np.stack([gt.fft_gtgram_db(c, CFG).astype(np.int16)
                       for c in clips])[..., :T]
    return (packed / 32767.0).astype(np.float32)


_VARS = {}


def flax_variables(name, feats):
    """The name's flax variables, bridged from the port's initialisation
    through sed_tpu's ``.pth`` reader; made once per name."""
    if name not in _VARS:
        seed = zlib.crc32(name.encode()) % 2 ** 31
        pm = get_model(name, CFG, feature_type='gamma')
        blocks.init_weights(pm, torch.Generator().manual_seed(seed))
        state = from_flax.reference_state_dict(pm.state_dict())
        variables = jax_loader.state_dict_to_variables(
            {k: v.numpy() for k, v in state.items()})
        variables = perturb(jax.tree.map(np.asarray, dict(variables)),
                            np.random.RandomState(seed))
        if 'bn0' in variables.get('batch_stats', {}):
            variables['batch_stats']['bn0'] = {
                'mean': feats.mean(axis=(0, 2)),
                'var': feats.var(axis=(0, 2))}
        _VARS[name] = variables
    return _VARS[name]


def _no_logmel(*args, **kwargs):
    raise AssertionError('a gamma model called the log-mel frontend')


def _models(name, feats):
    variables = flax_variables(name, feats)
    jm = jax_get_model(name, jax_config.AUDIO_16K, feature_type='gamma')
    pm = from_flax.load_variables(
        get_model(name, CFG, feature_type='gamma'), variables)
    return jm, variables, pm


@pytest.mark.parametrize('name', NAMES)
def test_gamma_eval_forward_matches_sed_tpu(name, feats):
    """Eval mode: sed_tpu's outputs and frame counts."""
    jm, variables, pm = _models(name, feats)
    want = jm.apply(variables, jnp.asarray(feats), train=False)
    with mock.patch('sed_tpu_torch.models.base.fused_logmel', _no_logmel), \
            torch.inference_mode():
        got = pm(torch.from_numpy(feats))
    assert set(got) == set(KEYS)
    for key in KEYS:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=2e-5, err_msg=key)
    frames = got['framewise_output'].shape[1]
    if name == 'Cnn14_DecisionLevelAtt':
        assert frames == T - 1
    assert np.isfinite(got['framewise_output'].numpy()).all()


@pytest.mark.parametrize('name', NAMES)
def test_gamma_train_mode_forward_matches_sed_tpu(name, feats, monkeypatch):
    """Training mode, augmentation off, every dropout inert on both
    sides: outputs on batch statistics and the BatchNorm buffers after
    the forward."""
    monkeypatch.setattr(jax_blocks.nn, 'Dropout', _NoDropout)
    jm, variables, pm = _models(name, feats)
    want, upd = jm.apply(variables, jnp.asarray(feats), train=True,
                         spec_augment=False, mutable=['batch_stats'],
                         rngs={'augment': jax.random.PRNGKey(0)})
    pm.train()
    zero_dropouts(pm)
    with mock.patch('sed_tpu_torch.models.base.fused_logmel', _no_logmel):
        got = pm(torch.from_numpy(feats), spec_augment=False,
                 generator=torch.Generator().manual_seed(0))
    for key in KEYS:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    stats = from_flax.state_dict_from_variables(
        {'batch_stats': jax.tree.map(np.asarray,
                                     upd.get('batch_stats', {}))})
    state = pm.state_dict()
    for k, w in stats.items():
        if k.endswith('num_batches_tracked'):
            continue
        d = (state[k] - w).abs() / w.abs().clamp_min(1.0)
        assert d.max() < 5e-5, (k, d.max())


@pytest.mark.parametrize('name,frames', [
    ('Cnn_9layers_Gru_FrameAtt', 1000), ('Cnn14_DecisionLevelAtt', 993),
    ('Cnn_9layers_Conformer', 992), ('VGGish_FrameAtt', 1000)])
def test_gamma_frames_of_a_packed_clip(name, frames):
    """At a packed 10 s clip's 994 frames the port gives sed_tpu's frame
    counts (measured with sed_tpu on the CPU): the GRU model pads 992 to
    1000, CNN14 to T - 1 = 993, the token-pooling Conformer keeps 992."""
    pm = get_model(name, CFG, feature_type='gamma')
    x = torch.zeros((1, CFG.mel_bins, 994))
    with torch.inference_mode():
        out = pm(x)
    assert out['framewise_output'].shape == (1, frames, 25)
