"""``Cnn14_DecisionLevelAtt`` of the port against the benchmark's plain
PyTorch reference (``bench_h100/configs/Cnn14_DecisionLevelAtt.py`` on
``bench_h100/reference/panns.py`` and ``plain.py``), on the CPU; the 3x3
kernel's product counters; the plain ADPCM decoder; and, on a card, the
counters and the ``sed::panns.head`` span of a forward.

Every leaf of the model is drawn from a seed (weights normal with
variance 1 / fan-in; BatchNorm scales, shifts and running statistics,
fc1's and the head's biases spread; ``bn0``'s statistics around the
features' own), in eval mode, at narrow widths on 1 s clips at the
configuration's 32 kHz front end: six blocks 8/16/16/32/32/64 (the
published depth and its x32 repeat) and the rehearsal's four blocks.
The tolerance, 1e-4 on the framewise and clipwise probabilities, is
rounding: both sides compute in float32 on the same CPU in a different
order of operations (the reference writes out its BatchNorms and its
smoothing by shifted slices) and land within ~1e-7 of each other; the
smoothing's max pool left out moves the output by ~6e-2, and the
bfloat16 reference by ~2e-3.
"""

import math
import os

import numpy as np
import pytest
import torch

from bench_h100 import common, harness, weights
from bench_h100.reference import adpcm, panns
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.ops import conv3x3 as cv

CELL = 'cnn14.serve.5s'
TOL = 1e-4
SIX = [8, 16, 16, 32, 32, 64]
FOUR = [8, 16, 16, 32]


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
    variances U(0.5, 1.5); biases, shifts and running means U(-0.2, 0.2);
    ``bn0``'s statistics the features' own per mel bin, moved by a
    draw."""
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
            out[name] = torch.randn(v.shape, generator=gen) \
                / math.sqrt(math.prod(v.shape[1:]))
        else:
            out[name] = u(v.shape, -0.2, 0.2)
    with torch.no_grad():
        feats = fused_logmel(wav, cfg)                   # (B, T, mel)
    out['bn0.running_mean'] = feats.mean(dim=(0, 1)) + u(
        (feats.shape[-1],), -1.0, 1.0)
    out['bn0.running_var'] = feats.var(dim=(0, 1)) * u(
        (feats.shape[-1],), 0.5, 1.5)
    return out


def _case(cell, channels, seed: int):
    """(config, tensors, program model, waveform) of one comparison: two
    1 s clips at the configuration's rate."""
    config = _config(cell, channels)
    cfg = common.program_audio(config)
    wav = torch.from_numpy(np.clip(make_clips(2, cfg.sample_rate, seconds=1,
                                              seed=seed), -1, 1))
    model = cell.reference.program_model(
        config, cell.reference.weights(config, seed, 'cpu', 'seeded'), cfg,
        'cpu')
    tensors = _random_leaves(model, cfg, wav, seed)
    weights.load_into(model, tensors)
    return config, tensors, model.eval(), wav


def _no_max(x, p):
    """The head with the smoothing's max pool dropped: a fault."""
    lo, hi = panns._neighbours(x, 0.0)
    return torch.relu(torch.nn.functional.linear(
        (lo + x + hi) / 3.0, p['fc1.weight'], p['fc1.bias']))


@pytest.mark.parametrize('channels', [SIX, FOUR], ids=['six', 'four'])
def test_program_matches_the_plain_reference(cell, channels):
    config, tensors, model, wav = _case(cell, channels, seed=11)
    with torch.no_grad():
        out = model(wav)
        framewise, clipwise = cell.reference.reference(tensors, wav, config)
        faulty, _ = cell.reference.reference(tensors, wav, config,
                                             temporal=_no_max)
        low, _ = cell.reference.reference(
            {k: v.to(torch.bfloat16) for k, v in tensors.items()}, wav,
            config, dtype=torch.bfloat16)
    # 1 s at 32 kHz, hop 320: 100 frames; the stack's frames repeated
    # 2^(blocks - 1) times (32 at six blocks: 3 x 32 = 96), padded
    assert framewise.shape == out['framewise_output'].shape == \
        (len(wav), 100, len(config['classes']))
    assert model.fc1.out_features == config['fc_width'] == 2048
    # the probabilities spread: the comparison is not of saturated sigmoids
    assert 0.03 < framewise.std().item()
    assert (framewise - out['framewise_output']).abs().max() < TOL
    assert (clipwise - out['clipwise_output']).abs().max() < TOL
    # the smoothing's max pool and the precision are visible at this
    # tolerance
    assert (faulty - out['framewise_output']).abs().max() > 10 * TOL
    assert (low - framewise).abs().max() > 10 * TOL


@pytest.mark.parametrize('frames', [1, 2, 5])
def test_smoothing_is_the_pools_of_the_program(frames):
    """The shifted slices equal the max and average pools the program
    runs (padding -inf and counted zeros), edges included."""
    x = torch.randn(2, frames, 7, generator=torch.Generator().manual_seed(3))
    t = x.transpose(1, 2)
    want = torch.nn.functional.max_pool1d(t, 3, 1, 1) + \
        torch.nn.functional.avg_pool1d(t, 3, 1, 1, count_include_pad=True)
    assert torch.allclose(panns.smoothing(x), want.transpose(1, 2),
                          atol=1e-6)


def test_configuration_module_at_a_reduced_size(cell):
    """``weights`` (both sources), ``program_model`` and ``reference``,
    with blocks 5-6 narrowed so that the stack stays small: blocks 1-4
    and ``bn0`` are the checkpoint's, everything else drawn from the
    configuration's ``head_seed`` whatever the run's seed."""
    config = _config(cell, [64, 128, 256, 512, 16, 32])
    cfg = common.program_audio(config)
    tensors = cell.reference.weights(config, 5, 'cpu', 'checkpoint')
    kept = weights.checkpoint('cpu', keep=('bn0', 'conv_block4'))
    assert all(torch.equal(tensors[k], v) for k, v in kept.items())
    again = cell.reference.weights(config, 6, 'cpu', 'checkpoint')
    assert all(torch.equal(v, again[k]) for k, v in tensors.items())
    assert torch.all(tensors['att_block.cla.bias'] == config['cla_bias'])
    # blocks 5-6's BatchNorms and fc1's bias drawn, not constant
    for key in ('conv_block5.bn1.weight', 'conv_block6.bn2.running_var',
                'conv_block6.bn2.running_mean', 'fc1.bias'):
        assert 0 < tensors[key].std() < 0.1, key
    assert tensors['fc1.weight'].shape == (2048, 32)
    model = cell.reference.program_model(config, tensors, cfg, 'cpu')
    wav = torch.from_numpy(make_clips(1, cfg.sample_rate, seconds=1, seed=4))
    with torch.no_grad():
        want = model(wav)
        got = cell.reference.reference(tensors, wav, config)
    assert (got[0] - want['framewise_output']).abs().max() < TOL
    assert (got[1] - want['clipwise_output']).abs().max() < TOL
    seeded = cell.reference.weights(_config(cell, SIX), 5, 'cpu', 'seeded')
    assert set(seeded) == {
        k for k in cell.reference.program_model(
            _config(cell, SIX), seeded, cfg, 'cpu').state_dict()
        if not k.endswith('num_batches_tracked')}
    with pytest.raises(ValueError, match='fc_width'):
        cell.reference.program_model(dict(config, fc_width=1024), tensors,
                                     cfg, 'cpu')


def test_configuration_is_the_published_model(cell):
    config = cell.config
    from sed_tpu_torch.models.panns import Cnn14DecisionLevelAtt
    assert tuple(config['conv_channels']) == \
        Cnn14DecisionLevelAtt.conv_channels
    assert config['reduced'] == []
    assert config['audio'] == {'sample_rate': 32000, 'window_size': 1024,
                               'hop_size': 320, 'mel_bins': 64, 'fmin': 50,
                               'fmax': 14000, 'ref': 1.0, 'amin': 1e-10}
    entry = [c for c in harness.load_json(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'BENCHMARK.json')['configs'] if c['name'] == config['name']][0]
    assert (entry['source'], entry['reduced']) == (config['source'],
                                                   config['reduced'])
    # 79.8 M parameters at the published widths, counted from shapes
    d, w, c = 2048, config['fc_width'], len(config['classes'])
    convs = sum(9 * a * b for a, b in zip([1] + config['conv_channels'][:-1],
                                          config['conv_channels'])) + sum(
        9 * b * b for b in config['conv_channels'])
    params = convs + d * w + w + 2 * (w * c + c)
    assert 79.7e6 < params < 79.9e6


def test_counted_operations_and_bytes(cell):
    config = cell.config
    flop, width = cell.reference.temporal_flop(config, 15, 2048)
    assert width == 2048
    assert flop == 15 * (2 * 2048 * 2048 + 6 * 2048)
    assert cell.reference.temporal_bytes(config, 15, 2048, 3) == \
        4 * (2048 * 2048 + 2048 + 3 * 15 * 4096)


def _tile_use(channels, frames=501, mels=64, batch=32):
    flop = tiles = 0
    cin = 1
    for i, c in enumerate(channels):
        for a, b in ((cin, c), (c, c)):
            f, t = cv.products(batch, a, b, frames, mels)
            flop, tiles = flop + f, tiles + t
        cin = c
        if i < len(channels) - 1:
            frames, mels = frames // 2, mels // 2
    return flop, tiles


def test_tile_products_of_the_two_stacks():
    """A 5 s clip (501 frames x 64 mels at 16 kHz hop 160 and at 32 kHz
    hop 320 alike) at batch 32: the 4-block stack's tiles are 97.5% the
    convolutions' own products, CNN14's 96.8% (its 31 x 4 and 15 x 2
    planes, which alone would fill 48% and 12% of a 256-pixel tile, go 2
    and 8 to a tile with a zero row between two: 40.2% one a tile)."""
    flop, tiles = _tile_use([64, 128, 256, 512])
    assert flop / 32 == pytest.approx(12.99e9, rel=1e-3)
    assert round(100 * flop / tiles, 1) == 97.5
    flop, tiles = _tile_use([64, 128, 256, 512, 1024, 2048])
    assert flop / 32 == pytest.approx(19.90e9, rel=1e-3)
    assert tiles / 32 == pytest.approx(20.56e9, rel=1e-3)
    assert round(100 * flop / tiles, 1) == 96.8
    # one image alone: a tile of its own
    assert cv.products(1, 1024, 2048, 31, 4) == (
        2 * 124 * 2048 * 9 * 1024, 2 * 256 * 2048 * 72 * 128)
    # two images of 31 x 4: one tile of 63 x 4 rows
    assert cv.products(2, 1024, 2048, 31, 4) == (
        2 * 2 * 124 * 2048 * 9 * 1024, 2 * 256 * 2048 * 72 * 128)
    # 32 images of 15 x 2: 4 tiles of 8 images
    assert cv.products(32, 2048, 2048, 15, 2) == (
        2 * 32 * 30 * 2048 * 9 * 2048, 2 * 4 * 256 * 2048 * 72 * 256)
    # a 1-channel input takes its 9 taps as 16; Cout and Cin round up
    assert cv.products(2, 1, 64, 16, 16) == (2 * 2 * 256 * 64 * 9,
                                             2 * 2 * 256 * 64 * 16)
    assert cv.products(1, 12, 70, 300, 1) == (
        2 * 300 * 70 * 9 * 12, 2 * 512 * 128 * 72 * 2)


def test_plain_adpcm_decoder_is_the_programs():
    """The benchmark's plain decoder equals ``audio_io.adpcm_decode_np``
    bit for bit: corpus clips, loud noise, a saturating square wave and
    silence, cut at lengths that leave a partial last block."""
    clips = make_clips(3, 16000, seconds=1, seed=8)
    rng = np.random.RandomState(2)
    noise = np.clip(rng.standard_normal((2, 16000)) * 0.6, -1, 1)
    square = np.where(np.arange(16000) % 40 < 20, 1.0, -1.0)[None]
    rows = np.concatenate([clips, noise, square,
                           np.zeros((1, 16000))]).astype(np.float32)
    for samples in (16000, 1234):
        wire = audio_io.adpcm_encode_np(rows[:, :samples])
        assert wire.shape[1] == audio_io.adpcm_bytes(samples)
        got = adpcm.decode(wire, samples)
        assert got.dtype == np.float32 and got.shape == (len(rows), samples)
        assert np.array_equal(got, audio_io.adpcm_decode_np(wire, samples))


def test_reference_files_import_nothing_of_the_program():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in ('bench_h100/reference/panns.py',
                 'bench_h100/reference/adpcm.py',
                 'bench_h100/configs/Cnn14_DecisionLevelAtt.py'):
        with open(os.path.join(here, path)) as f:
            text = f.read()
        head = text.split('def program_model')[0]
        for banned in ('sed_tpu', 'jax', 'flax'):
            assert f'import {banned}' not in head and \
                f'from {banned}' not in head, (path, banned)


def test_head_span_records_nothing_without_a_profiler(cell, monkeypatch):
    from sed_tpu_torch.utils import profiling
    config, _, model, wav = _case(cell, FOUR, seed=3)
    made = []
    monkeypatch.setattr(profiling, '_HostOp', lambda name: made.append(name))
    with torch.no_grad():
        model(wav)
    assert made == []


def test_head_span_covers_everything_after_the_stack(cell):
    from torch.profiler import ProfilerActivity, profile
    config, _, model, wav = _case(cell, FOUR, seed=3)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(wav)
    events = list(prof.events())
    head = [e for e in events if e.name == 'sed::panns.head']
    assert len(head) == 1 and not head[0].is_user_annotation
    inside = {e.name for e in events
              if e.cpu_parent is not None and e.cpu_parent is head[0]}
    assert {'aten::max_pool1d', 'aten::avg_pool1d', 'aten::linear',
            'aten::repeat_interleave'} <= inside
    convs = [e for e in events if e.name == 'aten::conv2d']
    assert convs and all(e.time_range.end <= head[0].time_range.start
                         for e in convs)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the 3x3 kernel has no CPU mode)')
    from sed_tpu_torch.serve import engine
    engine.disable_tf32()
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_counters_and_head_span_of_a_forward(cell, device):
    """One eval forward of CNN14 at the published widths and 32 kHz:
    12 launches of the 3x3 kernel whose counted products are those of
    the stack's shapes, blocks 5-6's 4 of them on packed tiles, and one
    ``sed::panns.head`` span with device time."""
    from torch.profiler import ProfilerActivity, profile
    config = cell.config
    cfg = common.program_audio(config)
    model = cell.reference.program_model(
        config, cell.reference.weights(config, 1, device, 'checkpoint'), cfg,
        device)
    wav = torch.from_numpy(make_clips(3, cfg.sample_rate, seconds=5,
                                      seed=6)).to(device)
    counts = (cv.conv3x3.launches, cv.conv3x3.packed, cv.conv3x3.flop,
              cv.conv3x3.tile_flop)
    with torch.no_grad(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = model(wav)
        torch.cuda.synchronize()
    flop, tiles = _tile_use(config['conv_channels'], batch=3)
    assert (cv.conv3x3.launches - counts[0], cv.conv3x3.packed - counts[1],
            cv.conv3x3.flop - counts[2],
            cv.conv3x3.tile_flop - counts[3]) == (12, 4, flop, tiles)
    assert out['framewise_output'].shape == (3, 500, 25)
    head = [e for e in prof.events() if e.name == 'sed::panns.head']
    assert len(head) == 1
    assert head[0].device_time_total > 0
