"""sed_tpu_torch's single-block Transformer models (``MultiHead``) and
reference ``.pth`` checkpoints, against the JAX package.

Small-width models start from a flax init with random batch statistics;
the full-width ``Cnn_9layers_Transformer_FrameAtt`` runs on
``compat.bench_weights.transformer_variables`` (the bench checkpoint's
conv stack and head, a seeded MultiHead).  Tolerance: atol 1e-4 on
probabilities and activations (fp32 on both sides, sums in another
order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.compat import torch_loader
from sed_tpu.config import AUDIO_8K, AUDIO_16K
from sed_tpu.models import blocks as jax_blocks
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu_torch.compat import bench_weights, from_flax
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.registry import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = 'Cnn_9layers_Transformer_FrameAtt'
ATOL = 1e-4
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402


def _random_stats(variables, seed):
    """flax init with batch statistics drawn from a numpy seed."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.uniform(-0.5, 0.5, v.shape) if k == 'mean'
                 else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    out = jax.tree_util.tree_map(np.asarray, dict(variables))
    out['batch_stats'] = walk(out['batch_stats'])
    return out


@pytest.fixture(scope='module')
def variables():
    return bench_weights.transformer_variables(seed=0)


@pytest.fixture(scope='module')
def jax_apply():
    """Jitted full-width flax forward, shared by the tests below."""
    model = jax_get_model(MODEL, AUDIO_16K)
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def test_multihead_matches_flax():
    """8 heads of 64 over d_model 48, nonzero biases; no residual, no
    layer norm, ReLU on the output."""
    x = np.random.RandomState(0).standard_normal((2, 13, 48)) \
        .astype(np.float32)
    jm = jax_blocks.MultiHead()
    v = jax.tree_util.tree_map(
        np.asarray, dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    rng = np.random.RandomState(1)
    for name in ('w_qs', 'w_ks', 'w_vs', 'fc'):
        b = v['params'][name]['bias']
        v['params'][name]['bias'] = rng.uniform(-0.3, 0.3, b.shape) \
            .astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.multihead = blocks.MultiHead(48).eval()     # flax's train=False
    from_flax.load_variables(holder, {'params': {'multihead': v['params']}})
    with torch.no_grad():
        got = holder.multihead(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 13, 48)
    assert (got == 0).any() and (got > 0).any()          # the ReLU bites
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize('model_type,channels,frames', [
    ('Cnn_9layers_Transformer_FrameAvg', (8, 16, 16, 32), 96),
    ('Cnn_9layers_Transformer_FrameAtt', (8, 16, 16, 32), 96),
    ('Cnn_14layers_Transformer_FrameAtt', (8, 8, 16, 16, 32, 32), 100)])
def test_small_transformer_models_match_flax(model_type, channels, frames):
    """1 s clips at 8 kHz (101 frames): the 9-layer entries keep the raw
    interpolated length (12 x 8 = 96), the 14-layer one pads 96 to 100."""
    cfg = AUDIO_8K
    wav = np.random.RandomState(6).uniform(-0.5, 0.5, (2, cfg.sample_rate)) \
        .astype(np.float32)
    jm = jax_get_model(model_type, cfg, conv_channels=channels)
    v = _random_stats(jm.init({'params': jax.random.PRNGKey(3)},
                              jnp.asarray(wav), train=False), seed=7)
    want = jm.apply(v, jnp.asarray(wav), train=False)
    tm = get_model(model_type, cfg, conv_channels=channels)
    from_flax.load_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(wav))
    assert got['framewise_output'].shape == (2, frames, 25)
    for key in ('framewise_output', 'clipwise_output', 'embedding'):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


def test_transformer_variables_key_and_shape_map(variables):
    """Every leaf of the tree maps to one state_dict entry of the port's
    full-width model with the transposed shape, and covers it."""
    model = get_model(MODEL, AUDIO_16K)
    model_state = model.state_dict()
    mapped = {}
    for collection in ('params', 'batch_stats'):
        for path, leaf in from_flax._flatten(variables[collection]).items():
            key, value = from_flax.torch_key(collection, path, leaf)
            assert key not in mapped, key
            assert tuple(model_state[key].shape) == value.shape, key
            mapped[key] = '/'.join((collection,) + path)
    assert mapped['multihead.w_qs.weight'] == 'params/multihead/w_qs/kernel'
    assert mapped['multihead.fc.bias'] == 'params/multihead/fc/bias'
    assert model_state['multihead.w_vs.weight'].shape == (512, 512)
    assert 'gru' not in variables['params']
    unmapped = {k for k in model_state if k not in mapped}
    assert all(k.endswith('num_batches_tracked') for k in unmapped), unmapped
    qs = variables['params']['multihead']['w_qs']['kernel']
    assert abs(qs.std() - np.sqrt(2.0 / 576)) < 2e-3


def test_full_width_transformer_matches_jax(variables, jax_apply):
    """Cnn_9layers_Transformer_FrameAtt at full width, 4 bench-corpus
    clips of 5 s: 496 framewise frames (no pad)."""
    cfg = AUDIO_16K
    clips = make_clips(4, cfg.sample_rate, seconds=5, seed=0)
    want = jax_apply(variables, jnp.asarray(clips))
    model = get_model(MODEL, cfg)
    from_flax.load_variables(model, variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(clips))
    assert got['framewise_output'].shape == (4, 496, 25)
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


def _reference_state_dict(variables) -> dict:
    """The port's state_dict in the reference's layout: the attention
    head's 1x1 Conv1d weights (O, I, 1), plus the frontend buffers and
    the MultiHead layer norm that the reference stores and never uses."""
    state = from_flax.state_dict_from_variables(variables)
    for name in ('att', 'cla'):
        key = f'att_block.{name}.weight'
        state[key] = state[key][:, :, None]
    rng = np.random.RandomState(5)
    state['logmel_extractor.melW'] = torch.from_numpy(
        rng.standard_normal((257, 64)).astype(np.float32))
    state['multihead.layer_norm.weight'] = torch.ones(512)
    return state


@pytest.mark.parametrize('layout', ['iteration_model', 'module_prefix',
                                    'bare'])
def test_pth_checkpoint_loads_as_sed_tpu_loads_it(variables, jax_apply,
                                                  tmp_path, layout):
    """A reference-layout .pth, wrapped as {'iteration', 'model'}, with
    DataParallel's ``module.`` prefixes, or bare: the port's loader and
    ``sed_tpu.compat.torch_loader`` give the same tree and outputs."""
    state = _reference_state_dict(variables)
    if layout == 'module_prefix':
        state = {f'module.{k}': v for k, v in state.items()}
    obj = state if layout == 'bare' else {
        'iteration': 7000, 'model': state,
        'optimizer': {'state': {}, 'param_groups': [{'lr': 1e-3}]}}
    path = str(tmp_path / 'best_logmel_16k.pth')
    torch.save(obj, path)

    want_vars, iteration = torch_loader.load_checkpoint_variables(path)
    assert iteration == (0 if layout == 'bare' else 7000)
    got_vars = from_flax.pth_variables(path)
    flat_want = from_flax._flatten(want_vars)
    flat_got = from_flax._flatten(got_vars)
    assert flat_got.keys() == flat_want.keys() == \
        from_flax._flatten(variables).keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])

    clips = make_clips(2, 16000, seconds=5, seed=1)
    want = jax_apply(want_vars, jnp.asarray(clips))
    model = from_flax.load_checkpoint(path, MODEL, AUDIO_16K, 'cpu')
    with torch.inference_mode():
        got = model(torch.from_numpy(clips))
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


def test_load_checkpoint_refuses_orbax_dir_and_other_files(tmp_path):
    with pytest.raises(ValueError, match='save_variables_npz'):
        from_flax.load_checkpoint(str(tmp_path), MODEL, AUDIO_16K, 'cpu')
    with pytest.raises(ValueError, match='.pth'):
        from_flax.load_checkpoint(str(tmp_path / 'w.ckpt'), MODEL,
                                  AUDIO_16K, 'cpu')


@pytest.mark.parametrize('key', [
    'encoder.conformer_blocks.0.ffn1.feed_forward_module.1.weight',
    'module.cnn.cnn.conv0.weight', 'vggish.features.0.weight'])
def test_pth_of_an_unported_family_raises(key):
    """No family is unported any more: Conformer / ESPnet encoder,
    baseline CNN and VGGish keys land where ``sed_tpu``'s name map puts
    them (the same tree, bitwise), and a key of no family still raises."""
    from sed_tpu_torch.compat import torch_loader as port_loader
    state = {key: np.arange(16, dtype=np.float32).reshape(4, 4)
             if 'ffn1' in key else
             np.arange(4 * 3 * 3 * 3, dtype=np.float32).reshape(4, 3, 3, 3)}
    got = port_loader.state_dict_to_variables(state)
    want = torch_loader.state_dict_to_variables(state)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)     # noqa: E731
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    assert all(np.array_equal(a, b) for (_, a), (_, b)
               in zip(flat(got), flat(want)))
    assert len(flat(got)) == 1
    with pytest.raises(KeyError, match='unmapped'):
        port_loader.state_dict_to_variables(
            {'encoder.embed.0.weight': np.zeros((4, 4), np.float32)})
