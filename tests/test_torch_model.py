"""sed_tpu_torch models and the flax -> PyTorch weight bridge, against
the JAX package.

Small-width blocks and models start from a flax init (with batch
statistics drawn from a numpy seed, so that a mean/var mix-up shows),
mapped through ``compat.from_flax``; inputs come from numpy seeds.
Tolerance: atol 1e-4 on probabilities and activations (fp32 on both
sides, sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_8K, AUDIO_16K
from sed_tpu.models import blocks as jax_blocks
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.compat import from_flax
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from sed_tpu_torch.models.zoo import CnnSed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
ATOL = 1e-4


def _random_stats(variables, seed):
    """Replace flax's init batch statistics (0, 1) with random ones."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.uniform(-0.5, 0.5, v.shape) if k == 'mean'
                 else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    out = jax.tree_util.tree_map(np.asarray, dict(variables))
    if 'batch_stats' in out:
        out['batch_stats'] = walk(out['batch_stats'])
    return out


def _to_numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.mark.parametrize('pool_type', ['avg', 'max', 'avg+max'])
def test_conv_block_matches_flax(pool_type):
    x = np.random.RandomState(0).standard_normal((2, 21, 16, 3)) \
        .astype(np.float32)                                 # (B, T, F, C)
    jm = jax_blocks.ConvBlock(8)
    variables = _random_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                              seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), pool_type=pool_type))
    tm = blocks.ConvBlock(3, 8).eval()
    from_flax.load_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 pool_type=pool_type).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 8, 8)         # pooling floors
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_att_block_matches_flax():
    x = np.random.RandomState(2).standard_normal((3, 12, 32)) \
        .astype(np.float32)
    jm = jax_blocks.AttBlock(7, activation='sigmoid')
    variables = _to_numpy_tree(jm.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))
    want = [np.asarray(a) for a in jm.apply(variables, jnp.asarray(x))]
    tm = blocks.AttBlock(32, 7, activation='sigmoid')
    from_flax.load_variables(tm, variables)
    with torch.no_grad():
        got = [t.numpy() for t in tm(torch.from_numpy(x))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_bigru_matches_flax():
    x = np.random.RandomState(3).standard_normal((2, 13, 10)) \
        .astype(np.float32)
    jm = jax_blocks.BiGRU(16)
    variables = _to_numpy_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    # nonzero biases, so that b_ih / b_hh placement is checked too
    rng = np.random.RandomState(4)
    for d in ('fw', 'bw'):
        for b in ('b_ih', 'b_hh'):
            variables['params'][d][b] = rng.uniform(
                -0.5, 0.5, variables['params'][d][b].shape).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.gru = blocks.BiGRU(10, 16)
    from_flax.load_variables(holder, {'params': {'gru': variables['params']}})
    with torch.no_grad():
        got = holder.gru(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 13, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_time_helpers_match_jax():
    x = np.random.RandomState(5).standard_normal((2, 62, 3)) \
        .astype(np.float32)
    up_j = jax_blocks.interpolate(jnp.asarray(x), 8)
    up_t = blocks.interpolate(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(up_t.numpy(), np.asarray(up_j))
    assert blocks.roundup(496) == jax_blocks.roundup(496) == 500
    assert blocks.roundup(500) == 500
    np.testing.assert_array_equal(
        blocks.pad_framewise_output(up_t, 500).numpy(),
        np.asarray(jax_blocks.pad_framewise_output(up_j, 500)))


SMALL = dict(conv_channels=(8, 16, 16, 32), gru_hidden=16)


@pytest.mark.parametrize('model_type', [
    'Cnn_9layers_FrameMax', 'Cnn_9layers_FrameAvg', 'Cnn_9layers_FrameAtt',
    'Cnn_9layers_Gru_FrameAvg', 'Cnn_9layers_Gru_FrameAtt',
    'Cnn_9layers_Gru_Reg'])
def test_small_model_matches_flax(model_type):
    """Registry models at small width (channels 8/16/16/32, GRU 16) from
    one flax init; 1 s clips at 8 kHz (101 frames -> 12 after pooling)."""
    cfg = AUDIO_8K
    wav = np.random.RandomState(6).uniform(-0.5, 0.5, (2, cfg.sample_rate)) \
        .astype(np.float32)
    kw = SMALL if 'Gru' in model_type else dict(
        conv_channels=SMALL['conv_channels'])
    jm = jax_get_model(model_type, cfg, **kw)
    variables = _random_stats(
        jm.init({'params': jax.random.PRNGKey(3)}, jnp.asarray(wav),
                train=False), seed=7)
    want = jm.apply(variables, jnp.asarray(wav), train=False)
    tm = get_model(model_type, cfg, **kw)
    from_flax.load_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(wav))
    for key in ('framewise_output', 'clipwise_output'):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


def test_bench_checkpoint_key_and_shape_map():
    """Every leaf of the bench checkpoint maps to one state_dict entry of
    the port's Cnn_9layers_Gru_FrameAtt with the transposed shape, and
    every model tensor is covered."""
    variables = load_variables_npz(CKPT)
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    model_state = model.state_dict()
    mapped = {}
    for collection in ('params', 'batch_stats'):
        for path, leaf in from_flax._flatten(variables[collection]).items():
            key, value = from_flax.torch_key(collection, path, leaf)
            assert key not in mapped, key
            assert key in model_state, ('/'.join(path), key)
            assert tuple(model_state[key].shape) == value.shape, key
            mapped[key] = '/'.join((collection,) + path)
    assert len(mapped) == 56
    assert mapped['conv_block2.conv1.weight'] == \
        'params/conv_block2/conv1/kernel'
    assert model_state['conv_block2.conv1.weight'].shape == (128, 64, 3, 3)
    assert mapped['gru.weight_hh_l0_reverse'] == 'params/gru/bw/w_hh'
    assert mapped['att_block.cla.weight'] == 'params/att_block/cla/kernel'
    assert mapped['bn0.running_var'] == 'batch_stats/bn0/var'
    unmapped = {k for k in model_state if k not in mapped}
    assert all(k.endswith('num_batches_tracked') for k in unmapped), unmapped
    state = from_flax.state_dict_from_variables(variables)
    assert set(state) == set(model_state)


def test_full_width_bench_checkpoint_matches_jax():
    """Cnn_9layers_Gru_FrameAtt at full width on the trained bench
    checkpoint, 4 bench-corpus clips of 5 s: 500 framewise frames."""
    import sys
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    cfg = AUDIO_16K
    clips = make_clips(4, cfg.sample_rate, seconds=5, seed=0)
    variables = load_variables_npz(CKPT)
    want = jax_get_model('Cnn_9layers_Gru_FrameAtt', cfg).apply(
        variables, jnp.asarray(clips), train=False)
    model = from_flax.load_npz(CKPT, 'Cnn_9layers_Gru_FrameAtt', cfg, 'cpu')
    with torch.inference_mode():
        got = model(torch.from_numpy(clips))
    assert got['framewise_output'].shape == (4, 500, 25)
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


@pytest.mark.parametrize('model_type', ['Cnn_9layers_Transformer_FrameAtt',
                                        'Cnn_9layers_Conformer_FrameAtt',
                                        'VGGish_FrameAtt', 'no_such_model'])
def test_unported_model_type_raises_with_ported_list(model_type):
    with pytest.raises(KeyError) as info:
        get_model(model_type, AUDIO_16K)
    assert 'Cnn_9layers_Gru_FrameAtt' in str(info.value)


def test_registry_lists_only_cnn_sed_without_multihead():
    assert sorted(MODEL_REGISTRY) == sorted([
        'Cnn_9layers_FrameMax', 'Cnn_9layers_FrameAvg',
        'Cnn_9layers_FrameAtt', 'Cnn_9layers_Gru_FrameAvg',
        'Cnn_9layers_Gru_FrameAtt', 'Cnn_14layers_Gru_FrameAtt',
        'Cnn_9layers_Gru_Reg'])


def test_multihead_and_train_mode_raise():
    with pytest.raises(NotImplementedError, match='MultiHead'):
        CnnSed(AUDIO_16K, temporal='multihead')
    model = get_model('Cnn_9layers_FrameAtt', AUDIO_8K,
                      conv_channels=(4, 4, 4, 4)).train()
    with pytest.raises(NotImplementedError, match='eval'):
        model(torch.zeros(1, 8000))
