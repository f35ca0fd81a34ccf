"""HTS-AT (``HTSAT_Swin_Transformer``, ``models/htsat.py``) of the port
against the benchmark's plain PyTorch reference
(``bench_h100/configs/HTSAT_Swin_Transformer.py`` on
``bench_h100/reference/htsat.py`` and ``plain.py``), on the CPU.

The comparisons run on seeded weights from the configuration module's
laws (Xavier-uniform linears, relative-position tables of deviation 1,
norms and biases around neutral, ``bn0`` at the features' statistics),
in eval mode, mostly at a small size that keeps the mechanism: 32 mel
bins folded 4 x into a 128 x 128 image, embed width 8, heads 1, 2, 4, 8,
4 x 4 windows, the published depths 2, 2, 6, 2, so that stages 1-3 roll
their odd blocks and stage 4's 4 x 4 grid is one window, on 5 s clips at
the configuration's 32 kHz front end (501 frames stretched to 512).
The tolerance, 1e-5 on the framewise and clipwise probabilities, is
rounding: both sides compute in float32 in different orders (the
reference gathers the windows through one index map and writes out its
norms, GELU and softmax) and land within ~1.5e-6 of each other; each
fault below moves the output by 7e-2 or more.
"""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from bench_h100 import common, generate, harness
from bench_h100.reference import htsat as R
from sed_tpu_torch import config as sed_config
from sed_tpu_torch.models import htsat as H
from sed_tpu_torch.models.registry import (MODEL_REGISTRY, PORT_REGISTRY,
                                           get_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'htsat.eval.10s'
TOL = 1e-5


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


def _small(config: dict) -> dict:
    return dict(config, audio=dict(config['audio'], mel_bins=32),
                spec_size=128, window_size=4, embed_dim=8,
                num_heads=[1, 2, 4, 8])


def _case(cell, config: dict, seed: int, clips: int = 2,
          seconds: int = 5):
    """(tensors, program model, waveform) of one comparison."""
    cfg = common.program_audio(config)
    tensors = cell.reference.weights(config, seed, 'cpu', 'seeded')
    model = cell.reference.program_model(config, tensors, cfg, 'cpu')
    wav, _ = generate.make_clips(clips, cfg.sample_rate, seconds, seed,
                                 config['classes'])
    return tensors, model.eval(), torch.from_numpy(wav)


@pytest.fixture(scope='module')
def small(cell):
    config = _small(cell.config)
    tensors, model, wav = _case(cell, config, seed=5)
    with torch.no_grad():
        out = model(wav)
    return config, tensors, wav, out


@pytest.mark.parametrize('seed', [2, 5])
def test_program_matches_the_plain_reference(cell, seed):
    config = _small(cell.config)
    tensors, model, wav = _case(cell, config, seed)
    with torch.no_grad():
        out = model(wav)
        framewise, clipwise = cell.reference.reference(tensors, wav, config)
    # 5 s at 32 kHz, hop 320: 500 frames (of the 512 the head gives)
    assert framewise.shape == out['framewise_output'].shape == \
        (2, 500, len(config['classes']))
    # the probabilities spread: the comparison is not of saturated sigmoids
    assert 0.1 < framewise.std().item()
    assert (framewise - out['framewise_output']).abs().max() < TOL
    assert (clipwise - out['clipwise_output']).abs().max() < TOL


def _mask_dropped(orig):
    return 'region_mask', lambda r, w, s: 0.0 * orig['region_mask'](r, w, s)


def _roll_flipped(orig):
    return 'window_index', lambda r, w, s: orig['window_index'](r, w, -s)


def _bias_transposed(orig):
    return 'relative_index', lambda w: orig['relative_index'](w).T


def _merge_swapped(orig):
    return 'MERGE_ORDER', ((0, 0), (0, 1), (1, 0), (1, 1))


def _fold_reversed(orig):
    def fold(f, chunks, width):
        return orig['fold_index'](f, chunks, width).reshape(
            chunks, f, width)[::-1].reshape(chunks * f, width)
    return 'fold_index', fold


@pytest.mark.parametrize('fault', [_mask_dropped, _roll_flipped,
                                   _bias_transposed, _merge_swapped,
                                   _fold_reversed],
                         ids=['mask', 'roll', 'bias', 'merge', 'fold'])
def test_the_comparison_catches_a_fault(cell, small, fault, monkeypatch):
    """The reference with one piece of the mechanism wrong moves the
    framewise output by more than 10x the tolerance."""
    config, tensors, wav, out = small
    orig = {k: getattr(R, k) for k in ('region_mask', 'window_index',
                                       'relative_index', 'MERGE_ORDER',
                                       'fold_index')}
    name, value = fault(orig)
    monkeypatch.setattr(R, name, value)
    with torch.no_grad():
        faulty, _ = cell.reference.reference(tensors, wav, config)
    assert (faulty - out['framewise_output']).abs().max() > 10 * TOL


def test_bfloat16_reference_fails_the_cells_limit(cell, small):
    config, tensors, wav, out = small
    with torch.no_grad():
        low, _ = cell.reference.reference(
            {k: v.to(torch.bfloat16) for k, v in tensors.items()}, wav,
            config, dtype=torch.bfloat16)
    assert (low - out['framewise_output']).abs().max() > \
        cell.spec['limits']['framewise_err']


@pytest.mark.parametrize('n_in,n_out', [(1001, 1024), (501, 512), (7, 20)])
def test_bicubic_stretch_is_interpolate(n_in, n_out):
    """The reference's matrix is bicubic ``F.interpolate``
    (``align_corners=True``) in float64, and the program's stretch is that
    rounded once to float32 (``F.interpolate`` in float32 takes its source
    positions in float32, ~1e-4 off at 1001 frames)."""
    x = torch.randn(2, 1, n_in, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(n_in))
    want = F.interpolate(x, (n_out, 3), mode='bicubic', align_corners=True)
    mat = torch.from_numpy(R.bicubic_matrix(n_in, n_out))
    assert torch.allclose(mat @ x, want, atol=1e-12)
    assert torch.allclose(mat.sum(dim=1), torch.ones(n_out, dtype=mat.dtype))
    got = H.stretch(x.float(), n_out)
    assert got.dtype == torch.float32
    assert torch.allclose(got.double(), mat @ x.float().double(), rtol=0,
                          atol=2 ** -22 * float(x.abs().max()))


def test_index_maps_are_the_programs_views():
    """The reference's window gather, region mask and relative index
    equal the program's roll and partition, shift mask and bias index,
    on a grid of distinct values."""
    r, w, s = 8, 4, 2
    grid = torch.arange(r * r, dtype=torch.float32).view(1, r, r, 1)
    rolled = torch.roll(grid, (-s, -s), (1, 2))
    want = H.window_partition(rolled, w)[..., 0]
    assert torch.equal(torch.from_numpy(R.window_index(r, w, s)).float(),
                       want)
    label = H.shift_mask(r, r, w, s)
    assert torch.equal(torch.from_numpy(R.region_mask(r, w, s)).float(),
                       label)
    assert torch.equal(torch.from_numpy(R.relative_index(w)),
                       H.relative_position_index(w))


def test_windows_and_tokens_counters(cell):
    config = _small(cell.config)
    tensors, model, wav = _case(cell, config, seed=3, clips=3)
    before = (H.SwinEncoder.windows, H.SwinEncoder.tokens)
    with torch.no_grad():
        model(wav)
    # grids 32, 16, 8, 4 in windows of 4, blocks 2, 2, 6, 2
    windows = 3 * (64 * 2 + 16 * 2 + 4 * 6 + 1 * 2)
    tokens = 3 * (1024 * 2 + 256 * 2 + 64 * 6 + 16 * 2)
    assert (H.SwinEncoder.windows - before[0],
            H.SwinEncoder.tokens - before[1]) == (windows, tokens)
    full = get_model('HTSAT_Swin_Transformer', sed_config.AUDIO_32K)
    assert (full.encoder.windows_a_clip, full.encoder.tokens_a_clip) == \
        (64 * 2 + 16 * 2 + 4 * 6 + 1 * 2, 4096 * 2 + 1024 * 2 + 256 * 6
         + 64 * 2) == (186, 11904)


def test_spans_under_the_cpu_profiler(cell):
    from torch.profiler import ProfilerActivity, profile
    config = _small(cell.config)
    _, model, wav = _case(cell, config, seed=4, clips=1)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(wav)
    events = list(prof.events())
    enc = [e for e in events if e.name == 'sed::htsat.encoder']
    attn = [e for e in events if e.name == 'sed::htsat.attn']
    head = [e for e in events if e.name == 'sed::htsat.head']
    assert (len(enc), len(attn), len(head)) == (1, sum(config['depths']), 1)
    assert not any(e.is_user_annotation for e in enc + attn + head)
    span = enc[0].time_range
    assert all(span.start <= e.time_range.start and
               e.time_range.end <= span.end for e in attn)
    assert head[0].time_range.start >= span.end
    inside = {e.name for e in events if e.cpu_parent is attn[0]}
    assert {'aten::linear', 'aten::matmul', 'aten::softmax'} <= inside
    # the shifted blocks roll inside their span
    assert any(e.name == 'aten::roll' and e.cpu_parent is attn[1]
               for e in events)


def test_published_widths_on_one_clip(cell):
    """The configuration's own sizes through the registry: 27.6 M
    parameters, one 10 s clip against the reference."""
    config = cell.config
    model = get_model('HTSAT_Swin_Transformer', sed_config.AUDIO_32K)
    params = sum(p.numel() for p in model.parameters())
    drawn = sum(math.prod(shape) for _, shape, _ in
                cell.reference.leaves(config).values())
    assert params == drawn + 2 * 64 == 27_649_713      # + bn0's affine
    tensors, model, wav = _case(cell, config, seed=7, clips=1, seconds=10)
    with torch.no_grad():
        out = model(wav)
        framewise, clipwise = cell.reference.reference(tensors, wav, config)
    assert out['framewise_output'].shape == (1, 1000, 25)
    assert (framewise - out['framewise_output']).abs().max() < TOL
    assert (clipwise - out['clipwise_output']).abs().max() < TOL


def test_configuration_module_at_the_rehearsals_narrowing(cell):
    """``weights`` (both sources), ``program_model`` and ``reference``
    at ``conv_channels`` [8, 16, 16, 32]: embed 8, heads 1, 2, 4, 8;
    ``fixed`` draws the same tensors whatever the run's seed."""
    config = dict(cell.config, conv_channels=[8, 16, 16, 32])
    cfg = common.program_audio(config)
    fixed = cell.reference.weights(config, 5, 'cpu', 'fixed')
    again = cell.reference.weights(config, 6, 'cpu', 'fixed')
    assert all(torch.equal(v, again[k]) for k, v in fixed.items())
    assert torch.all(fixed['tscam_conv.bias'] == config['tscam_bias'])
    assert fixed['patch_embed.proj.weight'].shape == (8, 1, 4, 4)
    table = fixed['encoder.layers.3.blocks.1.attn.'
                  'relative_position_bias_table']
    assert table.shape == (225, 8) and 0.8 < table.std() < 1.2
    for key in ('encoder.norm.weight', 'encoder.layers.0.blocks.0.attn.'
                'qkv.bias', 'bn0.weight'):
        assert 0 < fixed[key].std() < 0.1, key
    seeded = cell.reference.weights(config, 5, 'cpu', 'seeded')
    assert not torch.equal(seeded['tscam_conv.weight'],
                           fixed['tscam_conv.weight'])
    model = cell.reference.program_model(config, fixed, cfg, 'cpu')
    assert set(fixed) == {k for k in model.state_dict()
                          if not k.endswith('num_batches_tracked')}
    wav, _ = generate.make_clips(1, cfg.sample_rate, 10, 4,
                                 config['classes'])
    wav = torch.from_numpy(wav)
    with torch.no_grad():
        want = model(wav)
        got = cell.reference.reference(fixed, wav, config)
    assert (got[0] - want['framewise_output']).abs().max() < TOL
    assert (got[1] - want['clipwise_output']).abs().max() < TOL
    with pytest.raises(ValueError, match='fixed or seeded'):
        cell.reference.weights(config, 5, 'cpu', 'checkpoint')


def test_counted_operations(cell):
    """11.82 GFLOP a 10 s clip after log-mel at the published sizes, 0.48
    of them the attention's two products; width 0 for the yardstick's
    head term."""
    from bench_h100 import yardstick
    config = cell.config
    flop, width = cell.reference.temporal_flop(config, 1001, 1)
    assert width == 0
    assert flop == pytest.approx(11.8227e9, rel=1e-4)
    assert yardstick.body_flop(config, 320000,
                               cell.reference.temporal_flop) == flop
    enc = cell.reference.encoder_flop(config)
    attention = sum(4 * 64 * c * side * side * depth for c, side, depth in
                    ((96, 64, 2), (192, 32, 2), (384, 16, 6), (768, 8, 2)))
    assert attention == pytest.approx(0.478e9, rel=1e-3)
    assert flop - enc == 2 * 96 * 16 * 4096 + 2 * 25 * 768 * 6 * 32
    encoder_params = sum(math.prod(shape) for k, (_, shape, _) in
                         cell.reference.leaves(config).items()
                         if k.startswith('encoder.'))
    assert cell.reference.encoder_bytes(config, 3) == \
        4 * (encoder_params + 3 * (4096 * 96 + 64 * 768))


def test_configuration_is_the_published_model(cell):
    config = cell.config
    assert (config['spec_size'], config['patch_size'], config['embed_dim'],
            config['depths'], config['num_heads'], config['window_size'],
            config['mlp_ratio']) == (256, 4, 96, [2, 2, 6, 2],
                                     [4, 8, 16, 32], 8, 4)
    assert config['reduced'] == [] and config['conv_channels'] == []
    assert config['audio'] == {'sample_rate': 32000, 'window_size': 1024,
                               'hop_size': 320, 'mel_bins': 64, 'fmin': 50,
                               'fmax': 14000, 'ref': 1.0, 'amin': 1e-10}
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    entry = [c for c in bench['configs'] if c['name'] == config['name']][0]
    assert (entry['source'], entry['reduced'], entry['file']) == (
        config['source'], config['reduced'],
        'bench_h100/configs/HTSAT_Swin_Transformer.json')
    assert config['temporal'] == 'encoder'


def test_model_refusals_and_registry():
    cfg = sed_config.AUDIO_32K
    assert 'HTSAT_Swin_Transformer' in PORT_REGISTRY
    assert 'HTSAT_Swin_Transformer' not in MODEL_REGISTRY
    model = get_model('HTSAT_Swin_Transformer', cfg, embed_dim=8,
                      num_heads=(1, 2, 4, 8))
    with torch.no_grad(), pytest.raises(ValueError, match='at most 1024'):
        model(torch.zeros(1, 1025 * cfg.hop_size))
    with pytest.raises(NotImplementedError, match='eval mode'):
        model.train()(torch.zeros(1, cfg.sample_rate))
    with pytest.raises(ValueError, match='float32 only'):
        get_model('HTSAT_Swin_Transformer', cfg,
                  compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='log-mel'):
        get_model('HTSAT_Swin_Transformer', cfg, feature_type='gamma')


def test_reference_files_import_nothing_of_the_program():
    for path in ('bench_h100/reference/htsat.py',
                 'bench_h100/configs/HTSAT_Swin_Transformer.py'):
        with open(os.path.join(ROOT, path)) as f:
            text = f.read()
        head = text.split('def program_model')[0]
        for banned in ('sed_tpu', 'jax', 'flax'):
            assert f'import {banned}' not in head and \
                f'from {banned}' not in head, (path, banned)
