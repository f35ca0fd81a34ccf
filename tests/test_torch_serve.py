"""sed_tpu_torch serving engine and CLI against ``sed_tpu``'s engine, on
the trained bench checkpoint and bench-corpus clips.

Events and XML must be identical; framewise probabilities agree to
atol 1e-4 (fp32 on both sides, sums in another order).
"""

import os
import sys

import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.serve import engine as jax_engine
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.cli import predict as torch_predict_cli
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.ops.logmel_kernel import fused_logmel
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
ATOL = 1e-4
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402


@pytest.fixture(scope='module')
def engines():
    cfg = AUDIO_16K
    ref = jax_engine.SedInferenceEngine(
        jax_get_model(MODEL, cfg), load_variables_npz(CKPT), cfg,
        sample_duration=5, overlap=True, batch_size=8)
    port = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                     'cpu', sample_duration=5, overlap=True,
                                     batch_size=8)
    return ref, port


@pytest.fixture(scope='module')
def pcm_clips():
    clips = make_clips(8, AUDIO_16K.sample_rate, seconds=5, seed=0)
    return (np.clip(clips, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope='module')
def long_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp('wavs')
    path = str(d / 'long.wav')
    audio_io.save_wav(path, make_clips(1, AUDIO_16K.sample_rate, seconds=12,
                                       seed=3)[0], AUDIO_16K.sample_rate)
    return path


@pytest.mark.parametrize('duration', [0.5, 4.99, 5.0, 6.0, 12.0, 12.7])
@pytest.mark.parametrize('overlap', [True, False])
def test_window_starts_matches_jax(duration, overlap):
    assert engine.window_starts(duration, 5, overlap) == \
        jax_engine.window_starts(duration, 5, overlap)


def test_predict_clips_identical_to_jax_engine(engines, pcm_clips):
    ref, port = engines
    ev_ref, xml_ref = ref.predict_clips(pcm_clips)
    ev_port, xml_port = port.predict_clips(pcm_clips)
    assert sum(map(len, ev_ref)) > 0          # the trained model finds events
    assert ev_port == ev_ref
    assert xml_port == xml_ref


def test_infer_framewise_matches_jax_engine(engines, pcm_clips):
    ref, port = engines
    fw_ref, cw_ref = ref.infer_framewise(pcm_clips)
    fw_port, cw_port = port.infer_framewise(pcm_clips)
    assert fw_port.shape == fw_ref.shape == (8, 500, 25)
    np.testing.assert_allclose(fw_port, fw_ref, atol=ATOL)
    np.testing.assert_allclose(cw_port, cw_ref, atol=ATOL)


def test_predict_file_identical_to_jax_engine(engines, long_wav):
    """12 s wav: eight overlapped 1 s-hop windows, overlap-add merge."""
    ref, port = engines
    events, xml = port.predict_file(long_wav)
    assert (events, xml) == ref.predict_file(long_wav)
    assert xml.startswith('<AudioDoc name="long.wav">')


def test_predict_waveforms_identical_to_jax_engine(engines):
    ref, port = engines
    waves = [make_clips(1, 16000, seconds=s, seed=20 + s)[0]
             for s in (3, 7, 9)]
    names = ['a.wav', 'b.wav', 'c.wav']
    assert port.predict_waveforms(waves, names) == \
        ref.predict_waveforms(waves, names)


def test_cpu_engine_never_launches_the_kernel(engines, pcm_clips):
    _, port = engines
    before = fused_logmel.launches
    port.predict_clips(pcm_clips[:2])
    assert fused_logmel.launches == before == 0


def test_cuda_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA')
    model = load_npz(CKPT, MODEL, AUDIO_16K, 'cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        engine.SedInferenceEngine(model, AUDIO_16K, 'cuda')


def test_predict_clips_rejects_wrong_width(engines):
    _, port = engines
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips(np.zeros((2, 16000), np.int16))


@pytest.mark.parametrize('bulk', [0, 2])
def test_cli_predict_writes_engine_xml(engines, tmp_path, bulk):
    """``predict`` (one file at a time, and --bulk) writes the XML that
    the engine's predict_file gives, for a long and a short file."""
    _, port = engines
    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    audio_io.save_wav(str(in_dir / 'long.wav'),
                      make_clips(1, 16000, seconds=12, seed=3)[0], 16000)
    audio_io.save_wav(str(in_dir / 'short.wav'),
                      make_clips(1, 16000, seconds=3, seed=4)[0], 16000)
    ws = tmp_path / 'ws'
    torch_predict_cli.main([
        'predict', '--workspace', str(ws), '--input_dir', str(in_dir),
        '--audio_16k', '--overlap', '--checkpoint', CKPT, '--device', 'cpu',
        '--batch_size', '8', '--bulk', str(bulk)])
    for name in ('long', 'short'):
        written = (ws / 'predict_results' / f'{name}.xml').read_text()
        assert written == port.predict_file(str(in_dir / f'{name}.wav'))[1]


def test_cli_requires_npz_checkpoint_and_device(tmp_path):
    with pytest.raises(SystemExit):
        torch_predict_cli.main(['predict', '--workspace', str(tmp_path),
                                '--input_dir', str(tmp_path), '--audio_16k',
                                '--device', 'cpu'])
    argv = ['predict', '--workspace', str(tmp_path), '--input_dir',
            str(tmp_path), '--checkpoint', CKPT]
    # --device defaults to the card, and without CUDA that raises
    assert torch_predict_cli.get_parser().parse_args(argv).device == 'cuda'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            torch_predict_cli.main(argv)
