"""The model families beyond ``CnnSed`` in sed_tpu_torch (Conformer /
ESPnet encoders, token-pooling Conformers, VGGish, PANNs CNN14) against
``sed_tpu``: registry, eval and training-mode forwards, SpecAugment's
default, fresh initialisation, and ``.pth`` checkpoints both ways.

Inputs are made with numpy from a seed.  The nine names run at full
width (the 2048-channel ones included) on 1 s clips at 8 kHz, so each
stays cheap; the flax model of a name is initialised once (jitted) and
shared by the tests of this module, its 1-D leaves (biases, norm scales,
BatchNorm statistics) and the r_w / r_r biases moved off their init so
that no layer is an identity.  Variables cross through
``compat/from_flax.load_variables``, which is strict.

Tolerances: eval outputs ``rtol 1e-5 + atol 2e-5`` (measured: up to 5e-6
on probabilities and logits, 5e-6 on VGGish's embedding of scale 14; the
float32 sums run in different orders and flax's LayerNorm takes its
variance as E[x^2] - E[x]^2).  Training-mode outputs ``rtol 1e-4 + atol
1e-4``: the batch statistics of 2 clips x a handful of frames divide by
small variances (measured up to 2e-5).  BatchNorm buffers after a
training forward: 5e-5, relative above 1, the bound of
``tests/test_torch_train.py``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.compat import torch_loader as jax_loader
from sed_tpu.config import AUDIO_8K, AUDIO_16K
from sed_tpu.models import blocks as jax_blocks
from sed_tpu.models.registry import (MODEL_REGISTRY as JAX_REGISTRY,
                                     get_model as jax_get_model)
from sed_tpu_torch.compat import from_flax
from sed_tpu_torch.compat import torch_loader as port_loader
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from sed_tpu_torch.train import checkpoint as ckpt
from sed_tpu_torch.train.state import create_train_state

from test_compat import _randomize_bn_stats
from test_compat_families import (_TorchCnn14Oracle,
                                  _TorchConformerAttOracle,
                                  _TorchTokenPoolOracle,
                                  _TorchVggishAttOracle)
from test_torch_train import _NoDropout

NEW = ['Cnn_9layers_Conformer_FrameAtt', 'Cnn_9layers_Conformer_FrameAvg',
       'Cnn_14layers_Conformer_FrameAtt', 'Cnn_7layers_Conformer',
       'Cnn_9layers_Conformer', 'VGGish_FrameAtt', 'VGGish_Gru_FrameAtt',
       'VGGish_FrameAvg', 'Cnn14_DecisionLevelAtt']
CFG = AUDIO_8K
SAMPLES = CFG.sample_rate                       # 1 s
KEYS = ('framewise_output', 'clipwise_output', 'embedding')


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def perturb(tree, rng):
    def f(path, a):
        a = np.asarray(a)
        if a.ndim == 1:
            return a + 0.05 * np.abs(rng.randn(*a.shape)).astype(np.float32)
        if path[-1].key in ('r_w_bias', 'r_r_bias'):
            return a + 0.3 * rng.randn(*a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


_FLAX = {}


def flax_model(name, cfg=CFG, samples=SAMPLES, **kw):
    """(flax model, perturbed init variables), made once per name."""
    key = (name, cfg.name, tuple(sorted(kw.items())))
    if key not in _FLAX:
        seed = zlib.crc32(repr(key).encode()) % 2 ** 31   # of the name alone
        jm = jax_get_model(name, cfg, **kw)
        variables = jax.jit(lambda k: jm.init(
            {'params': k}, jnp.zeros((1, samples)), train=False))(
                jax.random.PRNGKey(seed))
        variables = perturb(jax.tree.map(np.asarray, dict(variables)),
                            np.random.RandomState(seed))
        _FLAX[key] = (jm, variables)
    return _FLAX[key]


def port_model(name, variables, cfg=CFG, **kw):
    return from_flax.load_variables(get_model(name, cfg, **kw), variables)


def zero_dropouts(model):
    n = 0
    for m in model.modules():
        for attr, value in list(vars(m).items()):
            if 'dropout' in attr and isinstance(value, float):
                setattr(m, attr, 0.0)
                n += 1
    return n


def _wav(n=2, samples=SAMPLES, seed=0):
    return np.random.RandomState(seed).uniform(
        -0.3, 0.3, (n, samples)).astype(np.float32)


def test_registry_has_sed_tpus_nineteen_names():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    assert len(MODEL_REGISTRY) == 19
    assert set(NEW) <= set(MODEL_REGISTRY)
    with pytest.raises(KeyError, match='unknown model_type') as info:
        get_model('no_such_model', CFG)
    assert 'VGGish_FrameAtt' in str(info.value)
    assert 'ported' not in str(info.value)


@pytest.mark.parametrize('name', NEW)
def test_eval_forward_matches_sed_tpu(name):
    jm, variables = flax_model(name)
    wav = _wav()
    want = jm.apply(variables, jnp.asarray(wav), train=False)
    pm = port_model(name, variables)
    assert not pm.training
    with torch.inference_mode():
        got = pm(torch.from_numpy(wav))
    assert set(got) == set(KEYS)
    for key in KEYS:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=2e-5, err_msg=key)
    if name.startswith('VGGish'):
        assert pm.bn0 is None
        assert not any(k.startswith('bn0') for k in pm.state_dict())
        assert got['framewise_output'].shape[1] == 1000
    if name in ('Cnn_7layers_Conformer', 'Cnn_9layers_Conformer'):
        # logits, not probabilities
        assert got['framewise_output'].min() < 0


def test_load_variables_is_strict():
    """A missing leaf and a leaf too many both raise; ``load_checkpoint``
    of a ``.pth`` alone drops the tensors the reference holds unused."""
    _, variables = flax_model('Cnn_7layers_Conformer')
    params = dict(variables['params'])
    params.pop('linear_emb')
    with pytest.raises(RuntimeError, match='linear_emb'):
        port_model('Cnn_7layers_Conformer',
                   {'params': params,
                    'batch_stats': variables['batch_stats']})
    _, vgg = flax_model('VGGish_FrameAtt')
    with pytest.raises(RuntimeError, match='bn0'):      # VGGish has none
        port_model('VGGish_FrameAtt', {'params': dict(
            vgg['params'], bn0=variables['params']['bn0'])})


@pytest.mark.parametrize('name', NEW)
def test_train_mode_forward_matches_sed_tpu(name, monkeypatch):
    """Training mode, augmentation off, every dropout inert on both
    sides: outputs on batch statistics, and the BatchNorm buffers after
    the forward (flax momentum 0.9; the baseline CNN's 0.01)."""
    monkeypatch.setattr(jax_blocks.nn, 'Dropout', _NoDropout)
    jm, variables = flax_model(name)
    wav = _wav(seed=1)
    want, upd = jm.apply(variables, jnp.asarray(wav), train=True,
                         spec_augment=False, mutable=['batch_stats'],
                         rngs={'augment': jax.random.PRNGKey(0)})
    pm = port_model(name, variables).train()
    n_rates = zero_dropouts(pm)
    assert n_rates > 0 or name.startswith('VGGish')
    got = pm(torch.from_numpy(wav), spec_augment=False,
             generator=torch.Generator().manual_seed(0))
    for key in KEYS:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    stats = from_flax.state_dict_from_variables(
        {'batch_stats': jax.tree.map(np.asarray,
                                     upd.get('batch_stats', {}))})
    state = pm.state_dict()
    n = 0
    for k, w in stats.items():
        if k.endswith('num_batches_tracked'):
            continue
        d = (state[k] - w).abs() / w.abs().clamp_min(1.0)
        assert d.max() < 5e-5, (k, d.max())
        n += 1
    assert n == sum(k.endswith(('running_mean', 'running_var'))
                    for k in state)


@pytest.mark.parametrize('name', sorted(MODEL_REGISTRY))
def test_spec_augment_is_on_by_default_in_training_mode(name):
    """A training-mode forward that omits the flag applies SpecAugment,
    as ``sed_tpu``'s models do, with its draws from the caller's
    generator; ``spec_augment=False`` draws nothing (dropouts at 0).  In
    eval mode the flag does nothing."""
    pm = get_model(name, CFG)
    blocks.init_weights(pm, torch.Generator().manual_seed(0))
    zero_dropouts(pm)
    wav = torch.from_numpy(_wav(seed=2))
    with torch.inference_mode():
        assert torch.equal(pm(wav)['clipwise_output'],
                           pm(wav, spec_augment=False)['clipwise_output'])
    pm.train()

    def run(**kw):
        g = torch.Generator().manual_seed(7)
        before = g.get_state()
        with torch.no_grad():
            out = pm(wav, generator=g, **kw)['framewise_output']
        return out, not torch.equal(before, g.get_state())

    default, drew = run()
    on, _ = run(spec_augment=True)
    off, drew_off = run(spec_augment=False)
    assert drew and not drew_off
    assert torch.equal(default, on)
    assert not torch.equal(default, off)


# ---------------------------------------------------------------------------
# fresh initialisation
# ---------------------------------------------------------------------------

def _fresh(name):
    return blocks.init_weights(get_model(name, AUDIO_16K),
                               torch.Generator().manual_seed(3))


_LECUN = {
    'encoder_linear': ('Cnn_7layers_Conformer',
                       'encoder.block1.ffn1.w_1.weight'),
    'encoder_qkv': ('Cnn_7layers_Conformer',
                    'encoder.block0.mhsa.qkv_net.weight'),
    'pointwise': ('Cnn_7layers_Conformer', 'encoder.block2.conv.pw1.weight'),
    'depthwise': ('Cnn_7layers_Conformer', 'encoder.block0.conv.dw.weight'),
    'baseline_conv': ('Cnn_7layers_Conformer', 'cnn.conv3.weight'),
    'linear_emb': ('Cnn_7layers_Conformer', 'linear_emb.weight'),
    'classifier': ('Cnn_7layers_Conformer', 'classifier.weight'),
    'vggish_conv': ('VGGish_FrameAvg', 'vggish.conv3.weight'),
    'input_layer': ('Cnn_9layers_Conformer_FrameAtt',
                    'encoder.input_layer.linear.weight'),
}


@pytest.mark.parametrize('kind', sorted(_LECUN))
def test_init_weights_lecun_normal_where_flax_defaults(kind):
    """flax's default kernel initialiser: a normal of variance 1 / fan_in
    cut at two (untruncated) standard deviations.  The sample standard
    deviation is held to 4 / sqrt(2 n) of it (four sigmas of its own
    sampling error) and no element lies beyond the cut."""
    name, key = _LECUN[kind]
    w = _fresh(name).state_dict()[key]
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5
    cut = 2.0 * std / .87962566103423978
    assert w.abs().max() <= cut * (1 + 1e-6)
    assert w.abs().max() > 0.8 * cut or w.numel() < 200
    n = w.numel()
    assert abs(w.std().item() / std - 1.0) < 4.0 / (2 * n) ** 0.5
    assert abs(w.mean().item()) < 4.0 * std / n ** 0.5


@pytest.mark.parametrize('name,key', [
    ('Cnn_9layers_Conformer_FrameAvg', 'fc.weight'),
    ('Cnn14_DecisionLevelAtt', 'fc1.weight'),
    ('VGGish_FrameAtt', 'att_block.cla.weight'),
    ('Cnn_9layers_Conformer', 'conv_block2.conv1.weight'),
    ('VGGish_FrameAvg', 'fc.weight')])
def test_init_weights_xavier_uniform_where_sed_tpu_names_it(name, key):
    w = _fresh(name).state_dict()[key]
    receptive = w[0, 0].numel()
    bound = (6.0 / ((w.shape[0] + w.shape[1]) * receptive)) ** 0.5
    assert w.abs().max() <= bound
    assert w.abs().max() > 0.95 * bound
    n = w.numel()
    assert abs(w.std().item() / (bound / 3 ** 0.5) - 1.0) < 4.0 / n ** 0.5


@pytest.mark.parametrize('name', ['Cnn_7layers_Conformer',
                                  'VGGish_Gru_FrameAtt'])
def test_init_weights_constants_and_moments_against_flax(name):
    """Biases, r_w / r_r biases 0; LayerNorm and BatchNorm 1 / 0 / 0 / 1;
    and every kernel's standard deviation within 10% of the flax init's
    own (tensors of 1000 elements and more)."""
    pm = _fresh(name)
    jm = jax_get_model(name, AUDIO_16K)
    variables = jax.jit(lambda k: jm.init(
        {'params': k}, jnp.zeros((1, 16000)), train=False))(
            jax.random.PRNGKey(5))
    want = from_flax.state_dict_from_variables(
        jax.tree.map(np.asarray, dict(variables)))
    got = pm.state_dict()
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith('num_batches_tracked'):
            continue
        if w.ndim == 1 or k.endswith(('r_w_bias', 'r_r_bias')):
            assert torch.equal(g, w), k           # the constants
        elif w.numel() >= 1000:
            assert abs(g.std() / w.std() - 1.0) < 0.1, k
            checked += 1
    assert checked >= 10


# ---------------------------------------------------------------------------
# .pth checkpoints
# ---------------------------------------------------------------------------

_ORACLES = {
    'Cnn_9layers_Conformer_FrameAtt': _TorchConformerAttOracle,
    'Cnn_7layers_Conformer': _TorchTokenPoolOracle,
    'VGGish_FrameAtt': _TorchVggishAttOracle,
    'Cnn14_DecisionLevelAtt': _TorchCnn14Oracle,
}


def _tree_equal(a, b, path=''):
    assert type(a) is type(b) or not isinstance(a, dict), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            _tree_equal(a[k], b[k], f'{path}/{k}')
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize('name', sorted(_ORACLES))
def test_reference_layout_pth_loads_as_sed_tpus_loader(name, tmp_path):
    """A ``.pth`` with the reference's key names (the torch oracles of
    ``tests/test_compat_families.py``, random weights): the port's name
    map gives the tree ``sed_tpu.compat.torch_loader`` gives, leaf for
    leaf and bitwise; ``load_checkpoint`` loads it strictly; and the
    loaded model's outputs are the oracle's own forward on the port's
    log-mel (atol 2e-5 on probabilities, rtol 1e-5 + 2e-5 on logits)."""
    from sed_tpu_torch.ops.logmel_kernel import logmel_plain
    torch.manual_seed(11)
    oracle = _ORACLES[name]().eval()
    _randomize_bn_stats(oracle, np.random.RandomState(11))
    if hasattr(oracle, 'encoder'):
        with torch.no_grad():
            for blk in oracle.encoder.conformer_blocks:
                blk.mhsa.r_w_bias.normal_(0, 0.3)
                blk.mhsa.r_r_bias.normal_(0, 0.3)
    path = str(tmp_path / 'ref.pth')
    torch.save({'iteration': 7, 'model': oracle.state_dict()}, path)

    want_vars, iteration = jax_loader.load_checkpoint_variables(path)
    assert iteration == 7
    _tree_equal(from_flax.pth_variables(path), want_vars)

    cfg = AUDIO_16K
    pm = from_flax.load_checkpoint(path, name, cfg, 'cpu')
    wav = torch.from_numpy(_wav(samples=2 * cfg.sample_rate, seed=4))
    with torch.inference_mode():
        got = pm(wav)
        want_frame, want_clip = oracle(logmel_plain(wav, cfg))
    np.testing.assert_allclose(got['framewise_output'].numpy(),
                               want_frame.numpy(), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got['clipwise_output'].numpy(),
                               want_clip.numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize('name', ['Cnn_9layers_Conformer_FrameAtt',
                                  'Cnn_7layers_Conformer',
                                  'VGGish_Gru_FrameAtt'])
def test_saved_checkpoint_is_read_by_the_port_and_by_sed_tpu(name, tmp_path):
    """``save_best_checkpoint`` writes the reference's layout (the
    oracle's key names where there is an oracle): ``sed_tpu``'s loader
    maps it onto the flax tree the weights came from, bitwise; the port's
    ``load_checkpoint`` and ``restore_checkpoint`` give the saved model
    back."""
    _, variables = flax_model(name)
    pm = port_model(name, variables)
    state = create_train_state(pm, 1e-3, fresh=False)
    path = ckpt.save_best_checkpoint(str(tmp_path), state)
    saved = torch.load(path, weights_only=True)['model']
    if name in _ORACLES:
        ref_keys = set(_ORACLES[name]().state_dict())
        mine = set(saved)
        # the oracle also holds the reference's buffers and its unused
        # tensors; every key the port saves is one of the reference's
        assert not mine - ref_keys, sorted(mine - ref_keys)[:5]
        assert all(k.split('.')[-1] in ('pe', 'inv_freq')
                   or k.split('.')[0] in ('classifier', 'linear_emb', 'bn0')
                   or 'att_block.bn_att.' in k
                   for k in ref_keys - mine), sorted(ref_keys - mine)[:5]
        for k, v in _ORACLES[name]().state_dict().items():
            if k in saved:
                assert saved[k].shape == v.shape, k
    got_vars, iteration = jax_loader.load_checkpoint_variables(path)
    assert iteration == 0
    _tree_equal(got_vars, jax.tree.map(np.asarray, variables))

    loaded = from_flax.load_checkpoint(path, name, CFG, 'cpu')
    fresh = create_train_state(get_model(name, CFG), 1e-3,
                               torch.Generator().manual_seed(1))
    ckpt.restore_checkpoint(path, fresh)
    for other in (loaded, fresh.model):
        for (k, a), (_, b) in zip(pm.state_dict().items(),
                                  other.state_dict().items()):
            assert torch.equal(a, b), k


def test_state_dict_layouts_are_inverse_for_every_name():
    for name in sorted(MODEL_REGISTRY):
        state = get_model(name, CFG).state_dict()
        ref = from_flax.reference_state_dict(state)
        back = from_flax.port_state_dict(ref)
        assert list(back) == list(state), name
        assert all(torch.equal(back[k], state[k]) for k in state), name
        # and the reference's map reads every key of it
        port_loader.state_dict_to_variables(
            {k: v.numpy() for k, v in ref.items()})
