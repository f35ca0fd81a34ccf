"""sed_tpu_torch's encoder library (``models/encoders.py``) against
``sed_tpu.models.encoders``, module by module.

Inputs are made with numpy from a seed at a small size (d_model 16 or
32, 4 heads, 12-24 frames); the flax module is initialised once, its
biases, LayerNorm and BatchNorm leaves are perturbed so that none is an
identity, and the tree is carried across by
``compat/from_flax.state_dict_from_variables`` and loaded strictly.

Tolerance: ``ATOL`` = 2e-5 absolute on outputs of unit scale.  The
products are float32 on both sides but summed in different orders, and
flax's LayerNorm takes the variance as E[x^2] - E[x]^2 where torch takes
E[(x - E[x])^2]: measured, a single module differs by up to ~2e-6 and
a three-layer encoder by up to ~6e-6.  Masks, tables and shapes are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.models import encoders as jenc
from sed_tpu_torch.compat.from_flax import state_dict_from_variables
from sed_tpu_torch.models import encoders as enc

ATOL = 2e-5


def _perturb(tree, rng):
    """Move every 1-D leaf (biases, LayerNorm / BatchNorm scale, bias,
    mean, var) and the zero-initialised r_w / r_r biases off its init."""
    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if a.ndim == 1:
            return a + 0.3 * np.abs(rng.randn(*a.shape)).astype(np.float32)
        if name in ('r_w_bias', 'r_r_bias'):
            return a + 0.5 * rng.randn(*a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _pair(jmod, pmod, *args, seed=0, **kwargs):
    """Init the flax module, perturb, load the port module; returns the
    flax variables."""
    rng = np.random.RandomState(seed)
    variables = jax.jit(lambda k: jmod.init(k, *args, **kwargs))(
        jax.random.PRNGKey(seed))
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)), rng)
    pmod.load_state_dict(state_dict_from_variables(variables), strict=True)
    return variables


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_numpy_helpers_are_sed_tpus():
    assert np.array_equal(enc.subsequent_mask(7), jenc.subsequent_mask(7))
    lengths = np.array([3, 9, 5])
    assert np.array_equal(enc.make_non_pad_mask(lengths, 9),
                          jenc.make_non_pad_mask(lengths, 9))
    assert np.array_equal(enc.sinusoidal_table(50, 16),
                          jenc.sinusoidal_table(50, 16))
    assert enc.MIN_VALUE == jenc.MIN_VALUE


def test_positional_encoding_scales_by_sqrt_d_and_interleaves():
    x = _x((2, 9, 16))
    want = jenc.PositionalEncoding(16).apply({}, jnp.asarray(x))
    got = enc.PositionalEncoding(16).eval()(torch.from_numpy(x))
    _close(got, want, 1e-6)
    pe = got.numpy() - x * 4.0
    np.testing.assert_allclose(pe[0, 3, 0::2], np.sin(3 * np.exp(
        np.arange(0, 16, 2) * -(np.log(10000.0) / 16))), atol=1e-5)


@pytest.mark.parametrize('masked', [False, True], ids=['full', 'padded'])
def test_multi_headed_attention(masked):
    x = _x((3, 12, 16))
    mask = jenc.make_non_pad_mask(np.array([12, 7, 9]), 12)[:, None, :] \
        if masked else None
    jm = jenc.MultiHeadedAttention(4, 16)
    pm = enc.MultiHeadedAttention(4, 16).eval()
    v = _pair(jm, pm, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x))
    jmask = None if mask is None else jnp.asarray(mask)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(x[::-1]),
                    jnp.asarray(x * 2), jmask)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = pm(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()),
             torch.from_numpy(x * 2), tmask)
    _close(got, want)


@pytest.mark.parametrize('shape', [(2, 3, 5, 5), (1, 2, 8, 8), (2, 1, 4, 6)],
                         ids=['q5', 'q8', 'q4k6'])
def test_rel_shift(shape):
    """Bitwise: the shift only moves values."""
    x = _x(shape)
    want = np.asarray(jenc.rel_shift(jnp.asarray(x)))
    got = enc.rel_shift(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    b, h, q, k = shape
    if q == k:                                  # row i is shifted left by
        assert got[0, 0, q - 1, 0] == x[0, 0, q - 1, 0]   # q - 1 - i
        assert got[0, 0, 0, 0] == x[0, 0, 0, k - 1]


@pytest.mark.parametrize('case', ['frames', 'tag_token', 'padded'])
def test_rel_multi_head_attn(case):
    """q = k = T for the plain sequence, T + 1 with the tag token in
    front (an odd length), and with a padding mask."""
    t = 13 if case == 'tag_token' else 12
    x = _x((2, t, 16))
    mask = jenc.make_non_pad_mask(np.array([12, 8]), 12)[:, None, :] \
        if case == 'padded' else None
    jm = jenc.RelMultiHeadAttn(4, 16, dropout_rate=0.0)
    pm = enc.RelMultiHeadAttn(4, 16, dropout_rate=0.0).eval()
    v = _pair(jm, pm, jnp.asarray(x))
    assert np.abs(pm.r_w_bias.detach().numpy()).max() > 0
    want = jm.apply(v, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))
    got = pm(torch.from_numpy(x),
             None if mask is None else torch.from_numpy(mask))
    _close(got, want)


def test_rel_pos_table_is_concatenated_not_interleaved():
    r = enc._rel_pos(5, 8, torch.device('cpu')).numpy()
    inv = 1.0 / (10000.0 ** (np.arange(0, 8, 2) / 8))
    pos = np.arange(4, -1, -1.0)
    np.testing.assert_allclose(r[:, :4], np.sin(pos[:, None] * inv),
                               atol=1e-6)
    np.testing.assert_allclose(r[:, 4:], np.cos(pos[:, None] * inv),
                               atol=1e-6)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_convolution_module(train):
    """Eval on the running statistics; training on the batch's, the
    BatchNorm buffers afterwards at flax's (momentum 0.9, biased
    variance), within 1e-6."""
    x = _x((3, 20, 16))
    jm = jenc.ConvolutionModule(16, dropout_rate=0.0, kernel_size=7)
    pm = enc.ConvolutionModule(16, dropout_rate=0.0, kernel_size=7)
    v = _pair(jm, pm, jnp.asarray(x))
    assert pm.dw.weight.shape == (16, 1, 7)
    pm.train(train)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), True,
                             mutable=['batch_stats'])
        got = pm(torch.from_numpy(x))
        _close(pm.bn.running_mean, upd['batch_stats']['bn']['mean'], 1e-6)
        _close(pm.bn.running_var, upd['batch_stats']['bn']['var'], 1e-6)
    else:
        want = jm.apply(v, jnp.asarray(x))
        got = pm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize('kind', ['conv2d', 'conv2d_no'])
def test_conv_input_layers_flatten_channel_major(kind):
    """(B, T, F) -> convs -> (B, T', C * F') with the channel the slow
    index, as the reference's ``transpose(1, 2).view``: the ``out``
    weights carry across without a reorder."""
    x = _x((2, 30, 20))
    if kind == 'conv2d':
        jm = jenc.Conv2dSubsampling(20, 8, dropout_rate=0.0)
        pm = enc.Conv2dSubsampling(20, 8, dropout_rate=0.0).eval()
        assert pm.out.in_features == 8 * 4
    else:
        jm = jenc.Conv2dNoSubsampling(8, dropout_rate=0.0)
        pm = enc.Conv2dNoSubsampling(20, 8, dropout_rate=0.0).eval()
    v = _pair(jm, pm, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    got = pm(torch.from_numpy(x))
    assert got.shape[1] == (6 if kind == 'conv2d' else 30)
    _close(got, want, 5e-5)       # scaled by sqrt(8), 160-term sums
    h = torch.arange(2 * 3 * 4 * 5.).reshape(2, 3, 4, 5)   # (B, C, T, F)
    flat = enc._flatten_channel_major(h)
    assert flat.shape == (2, 4, 15)
    assert torch.equal(flat[1, 2], h[1, :, 2, :].reshape(-1))


@pytest.mark.parametrize('case', ['linear', 'linear_masked', 'conv2d',
                                  'conv2d_no', 'after_conv'])
def test_transformer_encoder(case):
    layer = case.split('_masked')[0]
    after_conv = case == 'after_conv'
    if after_conv:
        layer = 'linear'
    x = _x((2, 24, 20))
    kw = dict(idim=20, adim=16, dropout_rate=0.0, elayers=2, eunits=32,
              aheads=4, transformer_input_layer=layer,
              after_conv=after_conv)
    jm = jenc.TransformerEncoder(**kw)
    pm = enc.TransformerEncoder(**kw).eval()
    mask = None
    if case in ('linear_masked', 'after_conv'):
        mask = jenc.make_non_pad_mask(np.array([24, 15]), 24)[:, None, :]
    v = _pair(jm, pm, jnp.asarray(x))
    want, want_mask = jm.apply(v, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask))
    got, got_mask = pm(torch.from_numpy(x),
                       None if mask is None else torch.from_numpy(mask))
    assert got.shape[1] == {'linear': 24, 'linear_masked': 24, 'conv2d': 5,
                            'conv2d_no': 24, 'after_conv': 6}[case]
    _close(got, want)
    if want_mask is None:
        assert got_mask is None
    else:
        assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_transformer_encoder_rejects_unknown_input_layer():
    with pytest.raises(ValueError, match='input_layer'):
        enc.TransformerEncoder(20, transformer_input_layer='embed')


@pytest.mark.parametrize('t', [24, 25], ids=['frames', 'tag_token'])
def test_conformer_encoder(t):
    x = _x((2, t, 20))
    kw = dict(idim=20, adim=16, dropout_rate=0.0, elayers=3, eunits=32,
              aheads=4, kernel_size=7)
    jm = jenc.ConformerEncoder(**kw)
    pm = enc.ConformerEncoder(**kw).eval()
    v = _pair(jm, pm, jnp.asarray(x))
    want, _ = jm.apply(v, jnp.asarray(x))
    got, _ = pm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize('activation', ['Relu', 'LeakyRelu', 'GLU', 'CG'])
def test_baseline_cnn(activation):
    """Each activation, in eval mode and in training mode; the BatchNorm
    buffers after the training forward follow torch momentum 0.99 (flax
    0.01), eps 1e-3, within 1e-5 (relative above 1)."""
    x = _x((2, 16, 8, 1))                         # flax (B, T, F, C)
    kw = dict(activation=activation, conv_dropout=0.0, kernel_size=(3, 3),
              padding=(1, 1), stride=(1, 1), nb_filters=(4, 6),
              pooling=((2, 2), (1, 2)))
    jm = jenc.BaselineCNN(**kw)
    pm = enc.BaselineCNN(in_channels=1, **kw).eval()
    v = _pair(jm, pm, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = jm.apply(v, jnp.asarray(x))
    _close(pm(xt).permute(0, 2, 3, 1), want)
    assert pm.bn0.eps == 1e-3 and pm.bn0.momentum == 0.99
    pm.train()
    want, upd = jm.apply(v, jnp.asarray(x), True, mutable=['batch_stats'])
    _close(pm(xt).permute(0, 2, 3, 1), want)
    for i in range(2):
        bn = getattr(pm, f'bn{i}')
        for ours, theirs in (('running_mean', 'mean'), ('running_var', 'var')):
            w = np.asarray(upd['batch_stats'][f'bn{i}'][theirs])
            g = getattr(bn, ours).numpy()
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def _all_dropouts(module):
    return [(m, a) for m in module.modules() for a in vars(m)
            if 'dropout' in a and isinstance(getattr(m, a), float)]


@pytest.mark.parametrize('name', ['conformer', 'transformer', 'baseline'])
def test_every_dropout_draws_from_the_callers_generator(name):
    """Training mode: the same seed gives the same output, another seed
    another, and torch's global generator is not touched.  Each dropout
    rate is an attribute: with all set to 0 no draw is made at all."""
    if name == 'conformer':
        pm = enc.ConformerEncoder(20, adim=16, elayers=1, eunits=32)
        x = torch.from_numpy(_x((2, 12, 20)))
        n_rates = 1 + 1 + 2 + 1 + 1    # input, its PE, ffn x2, mhsa, conv
    elif name == 'transformer':
        pm = enc.TransformerEncoder(20, adim=16, elayers=1, eunits=32,
                                    transformer_attn_dropout_rate=0.1)
        x = torch.from_numpy(_x((2, 24, 20)))
        n_rates = 1 + 1 + 1 + 1        # PE, layer, its attention and FFN
    else:
        pm = enc.BaselineCNN(nb_filters=(4,), kernel_size=(3,),
                             padding=(1,), stride=(1,), pooling=((1, 1),),
                             conv_dropout=0.1)
        x = torch.from_numpy(_x((2, 1, 12, 8)))
        n_rates = 1
    assert len(_all_dropouts(pm)) == n_rates
    pm.train()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        before = g.get_state()
        out = pm(x, generator=g)
        out = out[0] if isinstance(out, tuple) else out
        return out.detach(), not torch.equal(before, g.get_state())

    global_before = torch.get_rng_state()
    a, drew = run(1)
    b, _ = run(1)
    c, _ = run(2)
    assert drew and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(global_before, torch.get_rng_state())
    for m, attr in _all_dropouts(pm):
        setattr(m, attr, 0.0)
    d, drew = run(1)
    assert not drew
    pm.eval()
    e = pm(x)
    e = e[0] if isinstance(e, tuple) else e
    if name == 'transformer':           # no BatchNorm: train = eval now
        assert torch.allclose(d, e.detach(), atol=1e-6)


def test_no_attention_calls_scaled_dot_product_attention():
    import inspect
    from sed_tpu_torch.models import blocks
    for mod in (enc, blocks):
        src = inspect.getsource(mod)
        assert 'scaled_dot_product_attention(' not in src
