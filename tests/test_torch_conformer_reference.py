"""``Cnn_9layers_Conformer_FrameAtt`` of the port against the benchmark's
plain PyTorch reference (``bench_h100/configs/Cnn_9layers_Conformer_
FrameAtt.py`` on ``bench_h100/reference/conformer.py`` and ``plain.py``),
on the CPU, and the encoder's spans and counters.

Every leaf of the model is drawn from a seed: weights, biases, the
relative-position biases, every LayerNorm and BatchNorm scale and shift,
and the running statistics (``bn0``'s around the features' own, so that
the conv stack sees unit-scale inputs).  Eval mode, at a small size
(conv channels 8/16/16/32, 1 s clips) and at the published widths on one
2 s clip.  The tolerance, 1e-4 on the framewise and clipwise
probabilities, is rounding: both sides compute in float32 on the same
CPU, in a different order of operations (the reference's LayerNorm and
BatchNorm are written out, its positional tables are float64 rounded
once), and land within ~1e-6 of each other; a relative shift left out
moves the output by ~1e-2, and the bfloat16 reference by ~1e-2 too.
"""

import math
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from bench_h100 import common, harness, weights
from bench_h100.reference import conformer
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.models import encoders
from sed_tpu_torch.models.conformer_zoo import CONFORMER_KW

CELL = 'conformer.serve.5s'
TOL = 1e-4
NARROW = [8, 16, 16, 32]


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def cell():
    return harness.Cell.load(CELL)


def _config(cell, channels):
    return dict(cell.config, conv_channels=list(channels))


def _random_leaves(model, cfg, wav, seed: int) -> dict:
    """Every parameter and buffer of ``model`` drawn from ``seed``:
    weights normal with variance 1 / fan-in; norm scales and running
    variances U(0.5, 1.5); biases, shifts, running means and the
    relative-position biases U(-0.2, 0.2); ``bn0``'s statistics the
    features' own per mel bin, moved by a draw."""
    from sed_tpu_torch.models.base import fused_logmel
    gen = torch.Generator().manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)
    out = {}
    for name, v in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'running_var' or (leaf == 'weight' and v.dim() == 1):
            out[name] = u(v.shape, 0.5, 1.5)
        elif v.dim() >= 2 and leaf == 'weight':
            fan_in = math.prod(v.shape[1:])
            out[name] = torch.randn(v.shape, generator=gen) \
                / math.sqrt(fan_in)
        else:
            out[name] = u(v.shape, -0.2, 0.2)
    with torch.no_grad():
        feats = fused_logmel(wav, cfg)                   # (B, T, mel)
    out['bn0.running_mean'] = feats.mean(dim=(0, 1)) + u(
        (feats.shape[-1],), -1.0, 1.0)
    out['bn0.running_var'] = feats.var(dim=(0, 1)) * u(
        (feats.shape[-1],), 0.5, 1.5)
    return out


def _case(cell, channels, seconds: int, seed: int):
    """(config, tensors, program model, waveform) of one comparison."""
    config = _config(cell, channels)
    cfg = common.program_audio(config)
    clips = make_clips(2 if seconds == 1 else 1, cfg.sample_rate,
                       seconds=seconds, seed=seed)
    wav = torch.from_numpy(np.clip(clips, -1, 1))
    model = cell.reference.program_model(
        config, cell.reference.weights(config, seed, 'cpu', 'seeded'), cfg,
        'cpu')
    tensors = _random_leaves(model, cfg, wav, seed)
    weights.load_into(model, tensors)
    return config, tensors, model.eval(), wav


@pytest.mark.parametrize('channels,seconds', [(NARROW, 1),
                                              ([64, 128, 256, 512], 2)],
                         ids=['narrow_1s', 'published_2s'])
def test_program_matches_the_plain_reference(cell, channels, seconds):
    config, tensors, model, wav = _case(cell, channels, seconds, seed=11)
    with torch.no_grad():
        out = model(wav)
        framewise, clipwise = cell.reference.reference(tensors, wav, config)
        shiftless, _ = cell.reference.reference(tensors, wav, config,
                                                shift=lambda s: s)
        low, _ = cell.reference.reference(
            {k: v.to(torch.bfloat16) for k, v in tensors.items()}, wav,
            config, dtype=torch.bfloat16)
    assert framewise.shape == out['framewise_output'].shape == \
        (len(wav), 100 * seconds, len(config['classes']))
    # the probabilities spread: the comparison is not of saturated sigmoids
    assert 0.05 < framewise.std().item()
    assert (framewise - out['framewise_output']).abs().max() < TOL
    assert (clipwise - out['clipwise_output']).abs().max() < TOL
    # the shift and the precision are visible at this tolerance
    assert (shiftless - out['framewise_output']).abs().max() > 10 * TOL
    assert (low - framewise).abs().max() > 10 * TOL


@pytest.mark.parametrize('shape', [(2, 3, 5, 5), (1, 2, 8, 8), (2, 1, 4, 6),
                                   (1, 1, 7, 3), (1, 4, 62, 62)],
                         ids=['q5', 'q8', 'q4k6', 'q7k3', 'q62'])
def test_index_table_shift_equals_the_programs(shape):
    """Both only move values: equal bit for bit."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    want = encoders.rel_shift(x)
    got = conformer.rel_shift(x)
    assert torch.equal(got, want)
    b, h, q, k = shape
    if q == k:                 # relative distance i - j at j <= i
        i, j = q - 1, 1
        assert got[0, 0, i, j] == x[0, 0, i, k - 1 - (i - j)]


def test_shift_table_from_its_definition():
    """Output (i, j) is element i k + j + q of the left-padded buffer."""
    q, k = 3, 4
    padded = np.concatenate([np.zeros((q, 1)), np.arange(q * k).reshape(
        q, k) + 1.0], axis=1).reshape(-1)
    want = padded[q:q + q * k].reshape(q, k) - 1
    assert np.array_equal(conformer.shift_source(q, k), want)


@pytest.mark.parametrize('source', ['checkpoint', 'seeded'])
def test_benchmark_weights_load_into_the_program(cell, source):
    """No missing and no unexpected leaf (``weights.load_into`` raises);
    every encoder leaf drawn from a law that is not constant."""
    config = cell.config
    cfg = common.program_audio(config)
    tensors = cell.reference.weights(config, 5, 'cpu', source)
    model = cell.reference.program_model(config, tensors, cfg, 'cpu')
    for name, v in model.state_dict().items():
        if name.startswith('encoder.') and \
                not name.endswith('num_batches_tracked'):
            assert v.std() > 0, name
    assert {k for k in tensors if k.startswith('encoder.')} == {
        k for k in model.state_dict() if k.startswith('encoder.')
        and not k.endswith('num_batches_tracked')}
    if source == 'checkpoint':
        kept = weights.checkpoint('cpu', keep=('bn0', 'conv_block4'))
        for k, v in kept.items():
            assert torch.equal(tensors[k], v), k
        # the encoder and head come from the configuration's seed alone
        again = cell.reference.weights(config, 6, 'cpu', source)
        assert all(torch.equal(v, again[k]) for k, v in tensors.items())
        assert torch.all(tensors['att_block.cla.bias'] == config['cla_bias'])


def test_configuration_is_the_programs_conformer(cell):
    config = cell.config
    assert {k: config[k] for k in ('adim', 'aheads', 'elayers', 'eunits',
                                   'kernel_size')} == \
        {k: CONFORMER_KW[k] for k in ('adim', 'aheads', 'elayers', 'eunits',
                                      'kernel_size')}
    assert config['reduced'] == [] and 'd_model' not in config
    wrong = dict(config, eunits=512)
    cfg = common.program_audio(config)
    with pytest.raises(ValueError, match='Conformer'):
        cell.reference.program_model(
            wrong, cell.reference.weights(config, 0, 'cpu', 'checkpoint'),
            cfg, 'cpu')


def test_counted_operations_and_bytes_match_the_encoder(cell):
    """``temporal_flop``: the matrix products and the depthwise taps that
    torch's flop counter sees in one clip's encoder forward, less the
    relative embeddings' projection (once a forward, not a clip).
    ``temporal_bytes``: 4 bytes each of the encoder's parameters and
    buffers, and of a clip's input and output."""
    config = cell.config
    d, t = 512, 62
    enc = encoders.ConformerEncoder(d, **CONFORMER_KW).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        enc(torch.randn(1, t, d))
    flop, width = cell.reference.temporal_flop(config, t, d)
    r_net = config['elayers'] * 2 * t * config['adim'] ** 2
    assert width == config['adim']
    assert flop == counter.get_total_flops() - r_net
    leaves = sum(v.numel() for k, v in enc.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert cell.reference.temporal_bytes(config, t, d, 3) == \
        4 * (leaves + 3 * t * (d + config['adim']))


def test_encoder_spans_nest_and_counters_count_one_forward(cell):
    config = _config(cell, NARROW)
    cfg = common.program_audio(config)
    model = cell.reference.program_model(
        config, cell.reference.weights(config, 1, 'cpu', 'seeded'), cfg,
        'cpu')
    wav = torch.from_numpy(make_clips(3, cfg.sample_rate, seconds=1,
                                      seed=2))
    calls, tokens = encoders.ConformerEncoder.calls, \
        encoders.ConformerEncoder.tokens
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(wav)
    assert encoders.ConformerEncoder.calls - calls == 1
    frames = (cfg.sample_rate // cfg.hop_size + 1) // 2 // 2 // 2
    assert encoders.ConformerEncoder.tokens - tokens == 3 * frames
    got = [e for e in prof.events() if e.name.startswith('sed::conformer.')]
    names = [e.name[len('sed::conformer.'):] for e in
             sorted(got, key=lambda e: e.time_range.start)]
    layers = config['elayers']
    assert names == ['encoder'] + ['ffn', 'mhsa', 'conv', 'ffn'] * layers
    top = got[[e.name for e in got].index('sed::conformer.encoder')]
    assert not top.is_user_annotation
    for e in got:
        if e is not top:
            assert e.cpu_parent is top, e.name
            assert top.time_range.start <= e.time_range.start \
                <= e.time_range.end <= top.time_range.end


def test_spans_record_nothing_without_a_profiler(cell, monkeypatch):
    from sed_tpu_torch.utils import profiling
    made = []
    monkeypatch.setattr(profiling, '_HostOp', lambda name: made.append(name))
    enc = encoders.ConformerEncoder(32, **CONFORMER_KW).eval()
    with torch.no_grad():
        enc(torch.randn(2, 5, 32))
    assert made == []


def test_reference_imports_nothing_of_the_program():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in ('bench_h100/reference/conformer.py',
                 'bench_h100/configs/Cnn_9layers_Conformer_FrameAtt.py'):
        with open(os.path.join(here, path)) as f:
            text = f.read()
        head = text.split('def program_model')[0]
        for banned in ('sed_tpu', 'jax', 'flax'):
            assert f'import {banned}' not in head and \
                f'from {banned}' not in head, (path, banned)


def _trace(host, gaps, device_us):
    """A stand-in for ``bench_h100.trace.Trace``: host spans (name,
    thread, start, end) on measuring thread 1, the device's idle gaps,
    and the device time launched under each span name."""
    ev = [types.SimpleNamespace(name=name, thread=th,
                                time_range=types.SimpleNamespace(
                                    start=s, end=e))
          for name, th, s, e in host]
    return types.SimpleNamespace(
        host=ev, thread=1, idle_gaps=lambda: list(gaps),
        span_us=lambda name: device_us.get(name, 0.0),
        idle_share=lambda: 0.25)


# two encoder forwards of 32 clips; the device idle in [50, 80] and
# [250, 400]; 3000 us of device time under the encoder spans, 640 under
# the attention's
ENCODER = _trace(
    [('sed::conformer.encoder', 1, 0, 100),
     ('sed::conformer.mhsa', 1, 10, 20),
     ('sed::conformer.encoder', 1, 200, 300),
     ('sed::conformer.mhsa', 1, 210, 220),
     ('sed::conformer.encoder', 2, 0, 1000)],     # another thread: not read
    [(50, 80), (250, 400)],
    {'sed::conformer.encoder': 3000.0, 'sed::conformer.mhsa': 640.0})


def _reader(name):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return harness.load_module(
        os.path.join(here, 'bench_h100', 'metrics', f'{name}.py'),
        f'test_conformer_metric_{name}')


def _serve_info(cell):
    return {'kind': 'serve', 'traced_clips': 64, 'clip_samples': 80000,
            'config': cell.config, 'model': cell.reference}


def test_encoder_readers_read_the_programs_spans(cell):
    run = types.SimpleNamespace(trace=ENCODER, info=_serve_info(cell))
    assert _reader('mhsa_ms_per_clip.serve').read(run) == \
        pytest.approx(640 / 1e3 / 64, rel=1e-12)
    assert _reader('encoder_idle_ms_per_clip.serve').read(run) == \
        pytest.approx((30 + 50) / 1e3 / 64, rel=1e-12)
    # 5 s: 501 STFT frames, 62 after three poolings, 512 channels
    flop = 64 * cell.reference.temporal_flop(cell.config, 62, 512)[0]
    nbytes = 2 * cell.reference.temporal_bytes(cell.config, 62, 512, 32)
    least = max(flop / 67e12, nbytes / 3.35e12)
    assert flop / 67e12 > nbytes / 3.35e12          # bound by operations
    assert _reader('encoder_roofline.serve').read(run) == \
        pytest.approx(100 * least / 3000e-6, rel=1e-12)


@pytest.mark.parametrize('name', ['mhsa_ms_per_clip.serve',
                                  'encoder_idle_ms_per_clip.serve',
                                  'encoder_roofline.serve'])
def test_encoder_readers_are_silent_without_the_spans(cell, name):
    """A program without the spans (the benchmark's parent) reports
    nothing; a run of another kind neither."""
    reader = _reader(name)
    bare = _trace([(e.name.replace('sed::', 'aten::'), e.thread,
                    e.time_range.start, e.time_range.end)
                   for e in ENCODER.host], [(0, 100)], {})
    assert reader.read(types.SimpleNamespace(
        trace=bare, info=_serve_info(cell))) is None
    assert reader.read(types.SimpleNamespace(
        trace=ENCODER, info=dict(_serve_info(cell), kind='eval'))) is None


def test_eval_readers():
    from bench_h100 import yardstick
    gru = harness.Cell.load('gru.eval.10s-w6')
    info = {'kind': 'eval', 'windows': 576, 'window_s': 2.0,
            'config': gru.config, 'model': gru.reference,
            'window_samples': 96000}
    run = types.SimpleNamespace(trace=ENCODER, info=info)
    flop = yardstick.forward_flop(gru.config, 96000,
                                  gru.reference.temporal_flop)
    assert _reader('mfu.eval').read(run) == \
        pytest.approx(100 * flop * 576 / 2.0 / 989e12, rel=1e-12)
    assert _reader('device_idle.eval').read(run) == 25.0
    serve = types.SimpleNamespace(trace=ENCODER,
                                  info=dict(info, kind='serve'))
    assert _reader('mfu.eval').read(serve) is None
    assert _reader('device_idle.eval').read(serve) is None
