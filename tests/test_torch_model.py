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
from sed_tpu.models.registry import (MODEL_REGISTRY as JAX_REGISTRY,
                                     get_model as jax_get_model)
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


@pytest.mark.parametrize('model_type', ['Cnn_9layers_Conformer_FrameAvg',
                                        'Cnn_9layers_Conformer_FrameAtt',
                                        'VGGish_FrameAtt', 'no_such_model'])
def test_unported_model_type_raises_with_ported_list(model_type):
    """Every name of ``sed_tpu``'s registry is ported now: only a name
    that is in neither registry raises, and the error lists the names
    there are."""
    if model_type in JAX_REGISTRY:
        assert get_model(model_type, AUDIO_16K).cfg is AUDIO_16K
        return
    with pytest.raises(KeyError) as info:
        get_model(model_type, AUDIO_16K)
    assert 'Cnn_9layers_Gru_FrameAtt' in str(info.value)
    assert 'VGGish_FrameAtt' in str(info.value)


def test_registry_lists_only_cnn_sed_without_multihead():
    """The registry holds ``sed_tpu``'s 19 names: the CnnSed entries
    (the single-block Transformer ones included) and the Conformer,
    VGGish and CNN14 families."""
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    assert {'Cnn_9layers_FrameMax', 'Cnn_9layers_FrameAvg',
            'Cnn_9layers_FrameAtt', 'Cnn_9layers_Gru_FrameAvg',
            'Cnn_9layers_Gru_FrameAtt', 'Cnn_14layers_Gru_FrameAtt',
            'Cnn_9layers_Gru_Reg', 'Cnn_9layers_Transformer_FrameAvg',
            'Cnn_9layers_Transformer_FrameAtt',
            'Cnn_14layers_Transformer_FrameAtt'} < set(MODEL_REGISTRY)


def test_multihead_and_train_mode_raise():
    """MultiHead is ported now; an unknown temporal module still raises.
    The training-mode forward is ported too (since the training slice):
    it runs on batch statistics and moves bn0's running statistics."""
    assert isinstance(CnnSed(AUDIO_16K, temporal='multihead').multihead,
                      blocks.MultiHead)
    with pytest.raises(ValueError, match='temporal'):
        CnnSed(AUDIO_16K, temporal='conformer')
    model = get_model('Cnn_9layers_FrameAtt', AUDIO_8K,
                      conv_channels=(4, 4, 4, 4)).train()
    wav = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.3, 0.3, (2, 8000)).astype(np.float32))
    out = model(wav)
    assert torch.isfinite(out['framewise_output']).all()
    assert model.bn0.num_batches_tracked == 1
    assert not torch.equal(model.bn0.running_mean,
                           torch.zeros_like(model.bn0.running_mean))


def _parent_conv_forward(conv, x):
    """``blocks.Conv2d.forward`` as it was before eval-mode convolutions
    on the card ran under cuDNN's measured choice."""
    dt = conv.compute_dtype
    if dt is None:
        return torch.nn.Conv2d.forward(conv, x)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return conv._conv_forward(x.to(dt), conv.weight.to(dt), bias).to(x.dtype)


def _cudnn_flags():
    c = torch.backends.cudnn
    return (c.benchmark, c.benchmark_limit, c.deterministic, c.allow_tf32)


@pytest.mark.parametrize('dtype', [None, torch.bfloat16],
                         ids=['float32', 'bf16'])
@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_conv_block_on_cpu_unchanged_and_uncounted(monkeypatch, training,
                                                   dtype):
    """On the CPU, in either mode, a ConvBlock's output (and in training
    mode its running statistics) are bitwise the old forward's, and no
    convolution is counted as run under the measured choice."""
    torch.manual_seed(0)
    block = blocks.ConvBlock(3, 8, dtype=dtype).train(training)
    old = blocks.ConvBlock(3, 8, dtype=dtype).train(training)
    old.load_state_dict(block.state_dict())
    for conv in (old.conv1, old.conv2):
        monkeypatch.setattr(conv, 'forward',
                            lambda x, conv=conv: _parent_conv_forward(conv, x))
    x = torch.randn(2, 3, 21, 16)
    calls, searched = blocks.Conv2d.measured_calls, \
        blocks.Conv2d.searched_shapes
    with torch.no_grad():
        got, want = block(x), old(x)
    assert torch.equal(got, want)
    for k, v in old.state_dict().items():
        assert torch.equal(block.state_dict()[k], v), k
    assert (blocks.Conv2d.measured_calls, blocks.Conv2d.searched_shapes) \
        == (calls, searched)


@pytest.mark.parametrize('benchmark', [False, True])
def test_measured_choice_scope_and_counters(monkeypatch, benchmark):
    """With the card predicate faked true, an eval-mode ConvBlock in bf16
    (a compute dtype the 3x3 kernel does not take) runs each convolution
    with cuDNN's benchmark flag on, counts it, searches (inside a
    ``sed::conv.search`` span) once per new shape, and leaves every cuDNN
    flag as it found it, also when the forward raises."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(blocks, '_on_card', lambda x: True)
    monkeypatch.setattr(blocks.Conv2d, '_searched', set())
    inside = []
    compute = blocks.Conv2d._compute

    def spy(self, x):
        inside.append(torch.backends.cudnn.benchmark)
        return compute(self, x)
    monkeypatch.setattr(blocks.Conv2d, '_compute', spy)
    block = blocks.ConvBlock(3, 8, dtype=torch.bfloat16).eval()
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', benchmark)
    flags = _cudnn_flags()
    calls, searched = blocks.Conv2d.measured_calls, \
        blocks.Conv2d.searched_shapes

    def forward(x):
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                torch.no_grad():
            block(x)
        assert _cudnn_flags() == flags
        return sum(e.name == 'sed::conv.search' for e in prof.events())

    def counted():
        return (blocks.Conv2d.measured_calls - calls,
                blocks.Conv2d.searched_shapes - searched)
    assert forward(torch.randn(2, 3, 21, 16)) == 2
    assert counted() == (2, 2)
    assert forward(torch.randn(2, 3, 21, 16)) == 0
    assert counted() == (4, 2)
    assert forward(torch.randn(1, 3, 21, 16)) == 2
    assert counted() == (6, 4)
    assert inside == [True] * 6
    with pytest.raises(RuntimeError):
        block(torch.randn(2, 4, 21, 16))             # 4 channels, not 3
    assert _cudnn_flags() == flags
    assert counted() == (7, 4)


def test_measured_choice_restores_the_flag_on_an_exception(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', False)
    flags = _cudnn_flags()
    with pytest.raises(KeyError):
        with blocks.measured_choice():
            assert torch.backends.cudnn.benchmark
            raise KeyError('x')
    assert _cudnn_flags() == flags
