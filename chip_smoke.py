#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, int16 5 s clips -> events -> XML through
``sed_tpu_torch.serve.engine.SedInferenceEngine`` with
Cnn_9layers_Gru_FrameAtt at 16 kHz on the trained bench checkpoint, and
checks it against the same engine on the CPU.  Phases:

1. card, power limit, torch / CUDA versions, TF32 flags (both turned off);
2. build of the CUDA kernels from ``sed_tpu_torch/csrc`` (log-mel, the v6
   pool decode, the ADPCM decode, the conv epilogue and the 3x3
   convolution; one nvcc a source, started together,
   sm_90a), the time, and ptxas's registers, shared memory and spills (no
   spills);
3. kernel against its plain PyTorch version at 8, 16 and 32 kHz, with a
   frame count no tile divides, near-silent, digitally silent and
   full-scale clips, and with a mel filter on the Nyquist bin (rtol 1e-4,
   atol 1e-3 dB);
4. ``predict_clips`` on 64 int16 bench-corpus clips on the GPU: the
   kernel's launch count must rise, and the conv epilogue's by 8 a
   forward (``check_epilogues``); events and XML identical to the CPU
   engine, framewise output within 1e-4;
5. ``predict_file`` on a 12 s wav (overlapped windows): events and XML
   identical to the CPU engine;
6. times on the GPU: kernel against plain log-mel at 8, 16 and 32 kHz,
   batch 1 and 32 of 5 s clips (CUDA events, median of 20, in turns),
   with the kernel's achieved rate and, at 32 x 80000, its bound (the
   operations an FFT needs, or the bytes); ``predict_clips`` clips/s over 512
   clips at batch 32; a profiler breakdown of one batch; the conv
   epilogue kernel (``csrc/conv_epilogue.cu``) at each of the 8 epilogues
   of a 32 x 5 s forward against its plain version (relative error, the
   pool bitwise on its own BatchNorm-ReLU output) and its bytes' bound,
   both timed (``epilogue_checks``); the 3x3 convolution kernel
   (``csrc/conv3x3.cu``) at the 8 convolutions of a 32 x 5 s forward, a
   layer-4 one at batch 1 and the 8 of 27 windows of 6 s, against float64
   (within 4x of cuDNN fp32's error, 50x below one TF32 pass's) and timed
   against its plain version, cuDNN and its bound (``conv_checks``);
7. Cnn_9layers_Transformer_FrameAtt at full width on
   ``compat.bench_weights.transformer_variables``: ``predict_clips`` on
   the 64 int16 clips, GPU against CPU (events and XML identical,
   framewise and clipwise within 1e-4, 496 frames); clips/s over 512
   clips at batch 32; a profiler breakdown of one batch;
8. ``predict_clips_windowed`` (the ``inference_prob_overlap`` path) on 32
   bench-corpus clips of 10 s with the GRU model, for the five
   [overlap_value, window] combinations: events identical GPU against
   CPU, segment-based ER and F1 against the clips' ground truth equal;
   clips/s per combination; the kernel against plain at the 6 s, 7 s
   and 10 s inputs of the evaluation path (601, 701 and 1001 frames),
   checked and timed;
9. the ``Evaluator`` forward (``inference_prob``'s) on the 32 clips of
   10 s from an in-memory batch list with a ragged last batch, GPU
   against CPU: framewise within 1e-4;
10. the uint8 wires on the card: the 64 bench clips plus a full-scale
    square wave and digital silence, encoded as q2-q6, mu-law and
    adpcm4/3/2 by the port's numpy encoders, decoded on the GPU by
    ``ops.wire.dequant_wire`` bit-exact to the numpy decoders; the ADPCM
    kernel (``csrc/adpcm_decode.cu``) bit-exact to its plain version on
    the card for adpcm4/3/2 on the encodings, on 32 rows of random bytes
    and on 256 rows of 10 s, and timed against plain and its bound at 32
    x 80000 and 256 x 160000; ``predict_clips`` on the 64 clips as adpcm4
    (the ADPCM kernel's count must rise) and q6, events and XML identical
    to the CPU engine; decode device ms per batch of 32 (CUDA events),
    adpcm4 and int16 ``predict_clips`` clips/s over 512 clips in turns, a
    profiler breakdown of one adpcm4 batch, and the launches of one
    decode alone (the nodes of a CUDA graph that captures it; at most 2);
11. ``predict_clips_stream`` on 512 int16 clips in chunks of 32:
    identical to ``predict_clips``, clips/s; then on 512 wav files of 5 s
    (16 and 44.1 kHz, resampled on the host) read chunk by chunk in the
    caller's generator, against reading them all and ``predict_clips``
    (identical results, clips/s of both and of reading alone);
12. ``StreamingSed`` on a 30 s bench-corpus stream fed in random chunk
    sizes on the GPU: the events of all feeds and the flush equal the
    CPU engine's ``predict_waveform`` events;
13. training on the card: Cnn_9layers_Gru_FrameAtt at full width and
    depth, fresh init, ``BASELINE.json`` ``configs[4]``'s settings
    (batch 32 with ``specaugment_timeshift_mixup``: weak batches of 192
    and strong batches of 64 bench-corpus clips of 10 s, int16 as the
    HDF5 path ships them, clip_bce + frame_bce, AMSGrad at lr 1e-3)
    through ``train/step.py`` and ``train/prefetch.device_prefetch``: 5
    warm-up and 20 timed steps (steps/s, clips/s, peak memory, finite
    losses, 2 kernel launches a step), a profiler breakdown of one step;
    the kernel against plain at the training shapes (192 and 64 x
    160000), timed, and checked against a float64 evaluation (plain's
    own error is ~0.01-0.03 dB in the corpus's quiet frames); one and three steps GPU against CPU
    (weak 8, strong 4, mixup on, SpecAugment and timeshift off, the same
    initial weights); a static loss scale against the unscaled step and
    a step with an ``inf`` in the batch (everything kept, the dynamic
    scale halved); the Transformer (dropout on) for 5 steps; the
    trained model through ``save_best_checkpoint`` ->
    ``cli/common.checkpoint_path`` -> ``compat/from_flax.load_checkpoint``
    -> ``predict_clips``, events and XML equal to the in-memory model's;
14. the other model families, at full width and depth on seeded weights
    (``compat.bench_weights.seeded_model``): for each of the nine names
    (Conformer att / avg / 14-layer, the two token-pooling Conformers,
    VGGish att / GRU-att / avg, CNN14), and for CNN14 again at its
    published 32 kHz front end (``AUDIO_32K``: 64 clips of 160000
    samples, 12 3x3 convolutions and 12 epilogues a forward, up to 2048
    channels), ``predict_clips`` on the 64 int16 clips, GPU against CPU:
    framewise and clipwise within 1e-4 (logits: of max(1, |x|)), events
    compared as multisets with the differing ones counted and bounded
    (seeded weights leave many probabilities at a threshold; XML
    identical where the events are), clips/s over 512 clips;
    ``Cnn_9layers_Conformer_FrameAtt`` through
    ``predict_clips_windowed`` at [0.5, 6] on 16 clips of 10 s and
    ``StreamingSed`` on 30 s, GPU against CPU, and a profiler breakdown
    of one serving batch by op group (conv stack, linear layers,
    attention products, softmax, LayerNorm, depthwise conv, BatchNorm,
    pooling, log-mel), also for the 497-token ``Cnn_9layers_Conformer``;
    ``Cnn_9layers_Conformer_FrameAtt`` (BCE losses) and
    ``Cnn_7layers_Conformer`` (logits losses) trained at phase 13's
    batch for 12 steps (steps/s, peak memory, finite falling losses),
    one step GPU against CPU with dropout rates 0 and augmentation off
    under phase 13's bounds, and ``iter_N.pth`` -> ``load_checkpoint``
    -> ``predict_clips`` equal to the in-memory model.

15. ``BASELINE.json`` ``configs[3]``, the gammatone feature, at 8, 16 and
    32 kHz: pools of bench-corpus clips of 10 s packed on the host as
    ``data/hdf5_pack.py`` packs them (numpy ``fft_gtgram_db``, int16
    (64, 994)); ``dsp/gammatone.fft_gtgram_batch`` on 32 clips on the
    card against numpy float64 (2e-5 of each clip's largest value), timed
    against numpy; ``Cnn_9layers_Gru_FrameAtt(feature_type='gamma')``
    trained at phase 13's settings (fresh init, weak 192 + strong 64
    int16 feature rows a step drawn from the pools, through
    ``train/step.py`` and ``device_prefetch``): 3 warm-up and 10 timed
    steps (steps/s, clips/s, peak memory, finite losses, no log-mel
    launch), a profiler breakdown of one 16 kHz step; at 16 kHz one step
    GPU against CPU (weak 8 / strong 4, mixup on, SpecAugment and
    timeshift off) under phase 13's bounds, the ``Evaluator`` forward of
    the trained model on 32 packed clips GPU against CPU (within 1e-4)
    and ``save_best_checkpoint`` -> ``checkpoint_path`` ->
    ``load_checkpoint`` -> the same forward, equal; ``dsp/cqt.CQTFrontend``
    on 32 clips of 5 s GPU and CPU against float64 (the card within 1e-2
    dB of the CPU's own error), timed;
    ``dsp/transforms.istft`` of the STFT of those clips on the card
    against the clips (2e-3), timed.
16. the bf16 conv stack (``get_model(compute_dtype=torch.bfloat16)``):
    the GRU model on the bench checkpoint, ``predict_clips`` on the 64
    int16 clips against the float32 engine on the card (framewise within
    0.05, events matched both ways for >= 90% at 0.05 s, ``sed_tpu``'s
    gate), clips/s over 512 clips bf16 and float32 in turns, a profile of
    one bf16 batch by op group; training at phase 13's settings from the
    fresh init, bf16 with the dynamic loss scale and float32 from the same
    init, batch stream and generator, 25 steps each (steps/s, clips/s,
    peak memory, skipped steps, a profile of one bf16 step), every step's
    loss within ``BF16_LOSS_RTOL`` of float32's;
17. multi-device on the one card: (a) ``SedInferenceEngine(devices=
    ['cuda:0', 'cuda:0'])`` on the 64 int16 and adpcm4 clips, events and
    XML identical to one device, clips/s; (b) the data-parallel step
    (gradient and BatchNorm all-reduces) in a 1-rank NCCL group at phase
    13's batch against the single-process step, under phase 13's 1-step
    bounds; (c) two gloo ranks on cuda:0 (spawned), weak 96 + strong 32
    rows each, one step against the single-process step on the global
    batch: parameters under the 1-step bounds, each rank's log-mel
    launches; in (b) and (c) the dp step's gradients no further from the
    float64 step than ``DP_GRAD_FACTOR`` times the single-process step's
    (or 1e-5 of each tensor's max |g|); (d)
    ``parallel/dryrun.dryrun_multichip(4)`` in gloo processes on the
    host's CPU.
18. resident file serving and the v6 wire: the 64 clips written as
    int16, mu-law and IMA ADPCM wav and as ``.q4/.q5/.q6`` containers,
    each directory served by ``predict_files_resident`` through
    ``audio_io.wire_reader_for`` on the card: events and XML identical
    to ``predict_clips`` on the same wire rows, the first 8 clips to the
    CPU engine, passes of 24 clips (``max_pass_clips``) to one pass; the
    clips saved as ``.v6`` (payload sizes against q6's) and served by
    ``predict_files_resident_ragged`` and ``predict_rows_resident``:
    identical to the q6 files; ``predict --resident --device cuda`` on
    the int16 directory: XML files identical; clips/s over 512 clips for
    int16, adpcm4 and q6 files (reads included), v6 rows and
    ``predict_clips`` on int16, in turns; the v6 decode kernel (``csrc/v6_decode.cu``, the whole pool
    decode) on one 32-clip pool with a padding row: bit-exact to its
    plain version and to ``v6_decode_np``, the padding row silent, and to
    its plain version on a random-word pool; kernel and plain timed (CUDA
    events), the wrapper's host time, the decode's launches counted as
    the nodes of a CUDA graph that captures it (at most 2); which ADPCM
    encoder ran (native or numpy).
19. learning through the training CLI's loop
    (``main_strong.train_loop``, fed by
    ``tools/torch_synthetic_learning_check.py``'s in-memory corpus in
    place of the HDF5 files): (a) the 96/96/24/24-clip corpus of
    ``tools/make_bench_checkpoint.py``; (c) ``tools/bench_checkpoint.npz``
    (``sed_tpu``'s trained model) on its 24 test clips through the
    ``Evaluator`` on the card and the CPU (ER and F1 equal); (b)
    Cnn_9layers_Gru_FrameAtt trained in fp32 with
    ``tools/torch_make_bench_checkpoint.py``'s settings: ``sed_tpu``'s
    flags and its ``PRNGKey(0)`` initialisation (drawn in numpy by
    ``compat/flax_init.py``), 801 iterations, evaluated every 200
    (steps/s, train clips/s, the walls, peak memory, the trajectory,
    finite losses, 2 log-mel launches a step plus the evaluations'); (d)
    its best checkpoint held to (c) on the test split: ER within
    ``LEARN_ER_MARGIN`` above, F1 within ``LEARN_F1_MARGIN`` and
    framewise mAP within ``LEARN_MAP_MARGIN`` below; (h) that checkpoint
    exported by ``save_variables_npz``, served by ``predict_clips`` on the
    64 clips on the card and the CPU (events and XML identical), its test
    ER and F1 within ``EXPORT_TOL`` of the in-memory best's; (e) the same
    run in bf16 (dynamic loss scale) under (d)'s gate; (b') the GRU in
    fp32 from the port's own fresh draw (finite losses, the last 100
    iterations' mean below the first 100's; its test metrics printed
    beside the gate's); (f) Cnn_9layers_Conformer_FrameAtt from its
    fresh draw the same way, then served trained
    (clips/s, events a clip); (g) 20 iterations of the GRU on the adpcm4
    wire (the ADPCM kernel's count must rise).

``python3 chip_smoke.py --families-only`` runs phases 1, 2 and 14 alone,
``--gamma-only`` phases 1, 2 and 15, ``--bf16-only`` phases 1, 2 and 16,
``--parallel-only`` phases 1, 2 and 17 (the last two may be given
together), ``--resident-only`` phases 1, 2 and 18, ``--learning-only``
phases 1, 2 and 19, ``--adpcm-only``
phases 1, 2 and phase 10's ADPCM kernel checks and times
(``adpcm_kernel_checks``), ``--epilogue-only`` phases 1, 2 and phase 6's
conv epilogue checks and times (``epilogue_checks``), ``--conv-only``
phases 1, 2 and phase 6's 3x3 convolution checks and times
(``conv_checks``), and none prints a result line (for work on that
phase).

Phases 4, 7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 18 and 19 drive the main
paths: each sets the kernel's launch count to 0 just before and reads it
just after, and fails if the kernel was not launched; phases 10, 18 and
19 do the same for the ADPCM kernel on the adpcm4 paths, and phase 18 for
the v6 decode kernel on the v6 paths.  Phase 15 drives the
gamma path the same way and fails if log-mel was launched there: that
path has no kernel, its model takes packed features.  Every one of
these runs, phase 15's too, also sets the conv epilogue kernel's count
to 0 and fails unless it reads 2 launches for each ConvBlock of each
eval forward and none in a training step (``check_epilogues``), and the
same for the 3x3 convolution kernel: one launch for each float32 3x3
convolution of each eval forward (none in bf16 or training); the
result line's ``launches`` of those kernels add up these counts.  The
script imports nothing of JAX and nothing of the JAX package
``sed_tpu``, and checks so at the end.

Any failure raises (exit code != 0).  Without CUDA, or outside the
repository, it exits non-zero before printing a result.  The last line
is the JSON result; the line before it names the card and power limit.
"""

import dataclasses
import functools
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ('logmel', 'v6_decode', 'adpcm_decode',   # csrc/<name>.cu
           'conv_epilogue', 'conv3x3')
TOL = dict(rtol=1e-4, atol=1e-3)        # dB; tests/test_ops.py's tolerance
# Hopper's INT32 pipe: 64 operations a clock on each of an H100 SXM's 132
# SMs at its 1.98 GHz boost clock (the table's 67 T/s is float32 FMA)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
FRAMEWISE_ATOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events per run)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int = 20) -> float:
    """Device ms per ``fn()``: ``reps`` calls queued behind a spin
    kernel (``torch.cuda._sleep``) that lasts longer than the host takes
    to enqueue them, so that the CUDA events around them bracket their
    device work back to back and not the host's launch gaps (which
    ``cuda_ms`` sees for a call shorter than its own Python).  For a
    call of fewer launches than the device's launch queue holds."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * reps * host_s * 2e9) + 1000000)  # >2x, < 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(cfg, seed: int):
    """Bench-corpus clips plus a near-silent (level 1e-4, as the corpus's
    near-silent backgrounds), a half digitally silent and a full-scale
    +-1.0 clip, 5 s plus a few hops so that no 64-frame tile divides the
    frame count."""
    import numpy as np
    from sed_tpu_torch.bench_corpus import make_clips
    sr = cfg.sample_rate
    clips = make_clips(4, sr, seconds=5, seed=seed)
    extra = 3 * cfg.hop_size
    clips = np.concatenate([clips, clips[:, :extra]], axis=1)
    quiet = clips[0] / np.sqrt(np.mean(clips[0] ** 2)) * 1e-4
    half_silent = clips[1].copy()
    half_silent[:half_silent.size // 2] = 0.0
    full = np.where(clips[2] < 0, -1.0, 1.0).astype(np.float32)
    return np.concatenate([clips, quiet[None], half_silent[None],
                           full[None]])


def needed_gflop(cfg, rows: int) -> float:
    """Operations log-mel needs for ``rows`` frames, counted as an FFT
    does them: the window product (n), a real FFT of n points (2.5 n
    log2 n), the power spectrum (3 a bin), a multiply-add for each
    nonzero tap of the mel filters, and the dB scaling (4 a mel bin).
    The kernel does ~40x more: its DFT is a dense product."""
    import numpy as np
    from sed_tpu_torch.dsp.filters import frontend_arrays
    n, bins = cfg.window_size, cfg.window_size // 2 + 1
    taps = np.count_nonzero(frontend_arrays(cfg)[1])
    return rows * (n + 2.5 * n * np.log2(n) + 3 * bins + 2 * taps
                   + 4 * cfg.mel_bins) / 1e9


def bound_ms(cfg, wav_shape, frames: int) -> tuple:
    """The least time an H100 SXM could take for log-mel on a (B,
    samples) float32 input: the larger of the operations it needs
    (``needed_gflop``, fp32, at the 67 TFLOP/s of the fp32 units) and its
    bytes (waveform, window and mel matrix read once, log-mel written
    once) over 3.35 TB/s, with which of the two bounds it."""
    batch, samples = wav_shape
    bins = cfg.window_size // 2 + 1
    nbytes = 4 * (batch * samples + cfg.window_size + bins * cfg.mel_bins
                  + batch * frames * cfg.mel_bins)
    ops_ms = needed_gflop(cfg, batch * frames) / 67e12 * 1e12
    bytes_ms = nbytes / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms
                                   else 'bytes'), ops_ms, bytes_ms


def logmel_float64(wav, cfg):
    """The plain version's function in float64, on the same matrices."""
    from sed_tpu_torch.dsp import frontend as fe
    stft_mat, mel_mat = fe.frontend_matrices(cfg, wav.device)
    spec = fe.spectrogram(wav.double(), stft_mat.double(), cfg.hop_size,
                          center=cfg.center, pad_mode=cfg.pad_mode)
    return fe.power_to_db(spec @ mel_mat.double(), ref=cfg.ref,
                          amin=cfg.amin)


def check_against_float64(got, want, wav, cfg) -> tuple:
    """Kernel ``got`` within TOL of a float64 evaluation; against plain
    ``want`` within TOL plus plain's own distance from float64, element
    by element (plain's fp32 DFT sums cancel in quiet frames, ~80 dB
    below loud ones).  Returns the largest |kernel - float64| and
    |plain - float64|."""
    import torch
    ref = logmel_float64(wav, cfg)
    k_err = (got.double() - ref).abs()
    p_err = (want.double() - ref).abs()
    limit = TOL['atol'] + TOL['rtol'] * ref.abs()
    assert (k_err <= limit).all(), 'the kernel is off the float64 log-mel'
    assert ((got.double() - want.double()).abs() <= limit + p_err).all(), \
        'kernel and plain differ by more than plain\'s own error'
    return k_err.max().item(), p_err.max().item()


def time_kernel(fused_logmel, logmel_plain, wav, cfg, f64: bool = False):
    """Kernel and plain times (ms, median of 20 each, in turns plain,
    kernel, kernel, plain) and max |kernel - plain| in dB; checked
    against plain, or with ``f64`` by ``check_against_float64``."""
    import torch
    got, want = fused_logmel(wav, cfg), logmel_plain(wav, cfg)
    if f64:
        errs = check_against_float64(got, want, wav, cfg)
        print(f'[13] {tuple(wav.shape)}: max |kernel - float64| {errs[0]!r} '
              f'dB, max |plain - float64| {errs[1]!r} dB')
    else:
        torch.testing.assert_close(got, want, **TOL)
    times = {}
    for name, fn in (('plain', logmel_plain), ('kernel', fused_logmel),
                     ('kernel', fused_logmel), ('plain', logmel_plain)):
        times.setdefault(name, []).append(cuda_ms(lambda: fn(wav, cfg)))
    return times, (got - want).abs().max().item(), got.shape[1]


def clips_per_s(engine, bench, runs: int = 3, stream_chunk: int = 0):
    """``predict_clips`` (or, with ``stream_chunk``, ``predict_clips_stream``
    over chunks of that many clips) clips/s over ``bench`` after a
    warm-up, host clock around each run (which ends in the host's
    decode)."""
    import torch

    def run(wavs):
        if stream_chunk:
            return engine.predict_clips_stream(
                wavs[i:i + stream_chunk]
                for i in range(0, len(wavs), stream_chunk))
        return engine.predict_clips(wavs)

    run(bench[:64])
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev, _ = run(bench)
        rates.append(len(bench) / (time.perf_counter() - t0))
    return rates, sum(map(len, ev))


def file_stream(engine, paths, chunk: int = 32, runs: int = 3) -> dict:
    """Clips/s of serving wav files, read (and resampled to the engine's
    rate) by ``audio_io.load_audio`` on the host: reading alone; reading
    them all, then ``predict_clips`` ('plain'); ``predict_clips_stream``
    over a generator that reads each chunk's files ('stream').  Host
    clock, in turns; the stream must equal plain."""
    import numpy as np
    import torch
    from sed_tpu_torch.data import audio_io
    sr = engine.cfg.sample_rate

    def chunks():
        for i in range(0, len(paths), chunk):
            yield audio_io.stack_rows(audio_io.load_audio(p, sr)[0]
                                      for p in paths[i:i + chunk])

    modes = {'read': lambda: np.concatenate(list(chunks())),
             'plain': lambda: engine.predict_clips(
                 np.concatenate(list(chunks()))),
             'stream': lambda: engine.predict_clips_stream(chunks())}
    assert modes['stream']() == modes['plain'](), \
        'predict_clips_stream over read files differs from predict_clips'
    rates = {name: [] for name in modes}
    for r in range(runs):
        for name in (modes if r % 2 else reversed(list(modes))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            modes[name]()
            rates[name].append(round(len(paths) / (time.perf_counter() - t0),
                                     1))
    return rates


def profile_batch(engine, pcm, tag: str) -> None:
    """Profiler breakdown of one ``predict_clips`` call: wall, device
    kernel time, device idle share, the top kernels by self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict_clips(pcm)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f'[{tag}] profile of predict_clips({len(pcm)} clips): wall '
          f'{wall_us:.0f} us, device kernels {busy_us:.0f} us, device idle '
          f'share {1 - busy_us / wall_us:.3f}')
    for e in rows[:12]:
        print(f'[{tag}]   {e.self_device_time_total:10.0f} us  '
              f'x{e.count:<4d} {e.key[:90]}')


def graph_launches(fn) -> int:
    """Device operations (kernels, copies, memsets) that one ``fn()``
    enqueues: the nodes of a CUDA graph that captures it, read with the
    driver's ``cuGraphGetNodes``.  Exact where the profiler is not: a
    trace can drop every event of a call that makes one launch."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert rc == 0, f'cuGraphGetNodes failed ({rc})'
    graph.reset()
    return n.value


# the conv epilogue and 3x3 convolution launches that the main-path phases
# counted and checked, and the 3x3 launches on packed tiles among them
epilogue_launches = []
conv3x3_launches = []
conv3x3_packed = []


def reset_conv_counts() -> None:
    """Set the conv epilogue's and the 3x3 convolution's launch counts to
    0 before a run that ``check_epilogues`` checks."""
    from sed_tpu_torch.ops.conv3x3 import conv3x3
    from sed_tpu_torch.ops.conv_epilogue import conv_epilogue
    conv_epilogue.launches = 0
    conv3x3.launches = 0
    conv3x3.packed = 0


def check_epilogues(tag: str, model, forwards: int, packed: int = 0) -> None:
    """Fails unless ``conv_epilogue.launches``, set to 0 before the run
    (``reset_conv_counts``), is 2 for each ConvBlock of ``model`` in each
    of its ``forwards`` eval forwards: every BatchNorm + ReLU (+ pool) of
    the stack ran as the kernel; unless ``conv3x3.launches`` is 1 for
    each float32 3x3 ``blocks.Conv2d`` (stride 1, padding 1, no bias, no
    compute dtype) in each of them: every such convolution ran in
    ``csrc/conv3x3.cu``; and unless ``conv3x3.packed`` is ``packed``: the
    launches whose tiles hold several images (none in the 4-block stack,
    whose smallest plane is 62 x 8).  A training run gives ``forwards``
    0: no launch."""
    import torch
    from sed_tpu_torch.models.blocks import Conv2d, ConvBlock
    from sed_tpu_torch.ops.conv3x3 import conv3x3
    from sed_tpu_torch.ops.conv_epilogue import conv_epilogue
    blocks = sum(isinstance(m, ConvBlock) for m in model.modules())
    want = 2 * blocks * forwards
    assert conv_epilogue.launches == want, (
        f'{tag}: {conv_epilogue.launches} conv epilogue launches, not '
        f'{want} ({forwards} eval forwards of {blocks} ConvBlocks)')
    epilogue_launches.append(want)
    convs = sum(isinstance(m, Conv2d) and m._kernel_geometry
                and m.compute_dtype is None
                and m.weight.dtype == torch.float32
                for m in model.modules())
    want = convs * forwards
    assert conv3x3.launches == want, (
        f'{tag}: {conv3x3.launches} 3x3 convolution launches, not {want} '
        f'({forwards} eval forwards of {convs} float32 3x3 convolutions)')
    conv3x3_launches.append(want)
    assert conv3x3.packed == packed, (
        f'{tag}: {conv3x3.packed} 3x3 convolution launches on packed tiles, '
        f'not {packed}')
    conv3x3_packed.append(packed)


def decode_profile(dequant_wire, batch, tag: str) -> int:
    """Launches of one wire decode of ``batch`` (``graph_launches``) and
    its time between CUDA events (median of 20, the host's launch time
    included).  Returns the launches."""
    launches = graph_launches(lambda: dequant_wire(batch, 80000))
    ms = cuda_ms(lambda: dequant_wire(batch, 80000))
    print(f'[{tag}] one decode of {tuple(batch.shape)} {batch.dtype}: '
          f'{launches} device launches (nodes of a CUDA graph capturing '
          f'it), {ms!r} ms between CUDA events')
    return launches


def adpcm_bound_ms(rows: int, width: int, samples: int, bits: int) -> tuple:
    """The least time an H100 SXM could take for the ADPCM decode of a
    (rows, width) uint8 wire to (rows, samples) float32: the larger of
    its bytes (the wire read once, the output written once, the 89-entry
    step table and the index table) over 3.35 TB/s and its integer
    operations over the INT32 pipe's ~16.7 T/s (``INT32_OPS_PER_S``),
    counted per sample: the step
    lookup, the diff's shift and bits - 1 conditional adds (2 each), the
    sign, the clamped add of the predictor (3), the index lookup and its
    clamped add (4) and the scaling (2).  Returns (ms, 'bytes' or
    'operations', ops ms, bytes ms)."""
    nbytes = rows * width + 4 * rows * samples + 4 * (89 + (1 << bits))
    ops = rows * samples * (2 * (bits - 1) + 12)
    bytes_ms = nbytes / 3.35e12 * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms > bytes_ms
                                   else 'bytes'), ops_ms, bytes_ms


def epilogue_bound_ms(batch: int, channels: int, height: int, width: int,
                      pool) -> float:
    """The least time an H100 SXM could take for one conv epilogue: each
    input float read once, each output float written once, and the four
    (channels,) statistics, over 3.35 TB/s (its ~3 operations an element
    are far below 67 TFLOP/s)."""
    out = height // pool[0] * (width // pool[1])
    nbytes = 4 * (batch * channels * (height * width + out) + 4 * channels)
    return nbytes / 3.35e12 * 1e3


def epilogue_checks(card: str, dev, batch: int = 32,
                    frames: int = 501) -> dict:
    """The conv epilogue kernel at the 8 epilogues of a ``batch`` x
    ``frames``-frame forward of the 4-block stack (BatchNorm statistics
    of trained magnitudes): against ``conv_epilogue_plain`` (relative
    error, max |kernel - plain| over max |plain|, at most 1e-6; at a (2,
    2) pool the kernel equals ``F.avg_pool2d`` of its own (1, 1) output
    bit for bit), then timed by ``queued_ms`` (inputs read from device
    memory, not L2) against the plain version's three aten kernels and
    the bytes' bound.  Returns the JSON entry's numbers: the sums over
    the 8 epilogues of a forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from sed_tpu_torch.ops import conv_epilogue as ce
    gen = torch.Generator(device=dev).manual_seed(frames)
    rng = np.random.RandomState(frames)
    h, w, shapes = frames, 64, []
    for i, c in enumerate((64, 128, 256, 512)):
        pool = (1, 1) if i == 3 else (2, 2)
        shapes += [(c, h, w, (1, 1)), (c, h, w, pool)]
        h, w = h // pool[0], w // pool[1]
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    max_err = 0.0
    for c, h, w, pool in shapes:
        stats = [torch.from_numpy(rng.uniform(lo, hi, c).astype(
            np.float32)).to(dev) for lo, hi in ((-1, 1), (0.01, 4),
                                                (0.2, 2), (-1, 1))]
        x = torch.randn(batch, c, h, w, device=dev, generator=gen) * 2
        got = ce.conv_epilogue(x, *stats, 1e-5, pool)
        want = ce.conv_epilogue_plain(x, *stats, 1e-5, pool)
        torch.cuda.synchronize()
        err = ((got - want).abs().max() / want.abs().max()).item()
        max_err = max(max_err, err)
        assert err <= 1e-6, f'conv epilogue {c} x {h} x {w} {pool}: {err}'
        if pool == (2, 2):
            y = ce.conv_epilogue(x, *stats, 1e-5, (1, 1))
            assert torch.equal(got.view(torch.int32),
                               F.avg_pool2d(y, pool).view(torch.int32))
        # queued behind a spin kernel, so that the wrapper's host time is
        # not timed, over copies of x that together exceed the 50 MB L2:
        # every launch reads its input from device memory
        copies = itertools.cycle([x] + [x.clone() for _ in range(
            -(-150_000_000 // (4 * x.numel())) - 1)])
        times = {'kernel': [], 'plain': []}
        for name in ('kernel', 'plain', 'kernel', 'plain'):
            fn = ce.conv_epilogue if name == 'kernel' else \
                ce.conv_epilogue_plain
            times[name].append(queued_ms(
                lambda: fn(next(copies), *stats, 1e-5, pool)))
        ms, plain_ms = min(times['kernel']), min(times['plain'])
        bound = epilogue_bound_ms(batch, c, h, w, pool)
        total['ms'] += ms
        total['plain_ms'] += plain_ms
        total['bound_ms'] += bound
        print(f'[6] conv epilogue {batch} x {c} x {h} x {w} pool {pool} on '
              f'{card}: kernel {times["kernel"]} ms, plain {times["plain"]} '
              f'ms (20 calls queued, each side twice, in turns; plain = '
              f'cuDNN BatchNorm, clamp, avg_pool2d); bound {bound:.5f} ms by '
              f'bytes, kernel at {bound / ms:.4f} of it; relative error '
              f'{err!r}')
        del x, got, want, copies
    share = total['bound_ms'] / total['ms']
    print(f'[6] conv epilogue, the 8 of a {batch} x {frames}-frame forward: '
          f'kernel {total["ms"]:.5f} ms, plain {total["plain_ms"]:.5f} ms, '
          f'bound {total["bound_ms"]:.5f} ms ({share:.4f} of it); max '
          f'relative error {max_err!r}')
    return {**total, 'bound_by': 'bytes', 'max_rel_err': max_err}


# 3xTF32 on the H100's 495 TFLOP/s of dense TF32: three passes a product
CONV_PEAK_FLOPS = 495e12 / 3
# the 3x3 kernel's error against float64 may be this many times cuDNN
# fp32's on the same input (tests/test_torch_cuda.py's CONV_FP32_FACTOR),
# and one TF32 pass's must be CONV_TF32_MARGIN times the kernel's or more
CONV_FP32_FACTOR, CONV_TF32_MARGIN = 4.0, 50.0


def stack_convs(frames: int, width: int = 64) -> list:
    """(Cin, Cout, height, width) of the 8 convolutions of the 4-block
    stack on ``frames`` log-mel frames of ``width`` bins."""
    out, h, w, cin = [], frames, width, 1
    for i, c in enumerate((64, 128, 256, 512)):
        out += [(cin, c, h, w), (c, c, h, w)]
        cin = c
        if i < 3:
            h, w = h // 2, w // 2
    return out


# (Cin, Cout, height, width) of CNN14's blocks 5-6 on a 5 s clip: planes
# of 31 x 4 and 15 x 2, which the kernel packs 2 and 8 to a tile
CNN14_PACKED_CONVS = [(512, 1024, 31, 4), (1024, 1024, 31, 4),
                      (1024, 2048, 15, 2), (2048, 2048, 15, 2)]


def conv_bound_ms(batch: int, cin: int, cout: int, h: int, w: int) -> tuple:
    """The least time an H100 SXM could take for one fp32-accurate 3x3
    convolution: the larger of its operations (2 Cin Cout 9 H W an image)
    at 165 TFLOP/s (``CONV_PEAK_FLOPS``) and its bytes (input, weights and
    output once) over 3.35 TB/s; and which of the two bounds it."""
    ops_ms = 2 * cin * cout * 9 * h * w * batch / CONV_PEAK_FLOPS * 1e3
    bytes_ms = 4 * (batch * (cin + cout) * h * w + 9 * cin * cout) \
        / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms
                                   else 'bytes')


def conv_checks(card: str, dev) -> dict:
    """The 3x3 convolution kernel (``csrc/conv3x3.cu``) at the 8
    convolutions of a 32 x 5 s forward, one layer-4 convolution at batch 1
    (split K), the 8 of a forward of 27 windows of 6 s and CNN14's blocks
    5-6 at 32 x 5 s (packed tiles, ``CNN14_PACKED_CONVS``), on post-ReLU
    inputs and weights of the checkpoint's scale: its error against
    float64 (on the first two images) within CONV_FP32_FACTOR of cuDNN
    fp32's and CONV_TF32_MARGIN below one TF32 pass's; then timed by
    ``queued_ms`` (inputs read from device memory, not L2) against the
    plain version (three cuDNN passes), the library (``F.conv2d`` under
    the measured choice, TF32 off; the port never calls it for these) and
    the bound.  Returns the JSON entry's numbers: the sums over the 8
    convolutions of the 32 x 5 s forward."""
    import torch
    import torch.nn.functional as F
    from sed_tpu_torch.models.blocks import measured_choice
    from sed_tpu_torch.ops import conv3x3 as cv
    from sed_tpu_torch.ops.logmel_kernel import tf32_round
    gen = torch.Generator(device=dev).manual_seed(19)
    cases = [('5 s x 32', 32, c) for c in stack_convs(501)] \
        + [('5 s x 1', 1, stack_convs(501)[-1])] \
        + [('6 s x 27', 27, c) for c in stack_convs(601)] \
        + [('CNN14 5 s x 32', 32, c) for c in CNN14_PACKED_CONVS]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst = 0.0

    def library(x, w):
        with measured_choice():
            return F.conv2d(x, w, padding=1)

    def plain(x, w):
        with measured_choice():
            return cv.conv3x3_plain(x, w)

    for tag, batch, (cin, cout, h, w) in cases:
        x = torch.randn(batch, cin, h, w, device=dev, generator=gen).relu()
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) \
            / (3 * cin ** 0.5)
        planes = cv.weight_planes(wt)
        ref = F.conv2d(x[:2].double(), wt.double(), padding=1)
        errs = [((y[:2].double() - ref).abs().max() / ref.abs().max()).item()
                for y in (cv.conv3x3(x, wt, planes), library(x, wt),
                          F.conv2d(tf32_round(x), tf32_round(wt), padding=1))]
        worst = max(worst, errs[0] / errs[1])
        assert errs[0] <= CONV_FP32_FACTOR * errs[1] and \
            errs[0] * CONV_TF32_MARGIN <= errs[2], (tag, cin, cout, errs)
        copies = itertools.cycle([x] + [x.clone() for _ in range(
            -(-150_000_000 // (4 * x.numel())) - 1)])
        times = {'kernel': [], 'plain': [], 'library': []}
        fns = {'kernel': lambda x: cv.conv3x3(x, wt, planes),
               'plain': lambda x: plain(x, wt),
               'library': lambda x: library(x, wt)}
        for name in ('kernel', 'plain', 'library') * 2:
            times[name].append(queued_ms(lambda: fns[name](next(copies)),
                                         reps=10))
        ms = {k: min(v) for k, v in times.items()}
        bound, by = conv_bound_ms(batch, cin, cout, h, w)
        if tag == '5 s x 32':
            total['ms'] += ms['kernel']
            total['plain_ms'] += ms['plain']
            total['library_ms'] += ms['library']
            total['bound_ms'] += bound
        print(f'[6] conv3x3 {tag}: {cin} -> {cout} at {h} x {w} on {card}: '
              f'kernel {times["kernel"]} ms ({bound / ms["kernel"]:.4f} of '
              f'the bound, {bound:.5f} ms by {by}), plain {times["plain"]} '
              f'ms, library {times["library"]} ms (10 calls queued, each '
              f'side twice, in turns); error against float64: kernel '
              f'{errs[0]:.3e}, cuDNN fp32 {errs[1]:.3e}, one TF32 pass '
              f'{errs[2]:.3e}')
        del x, copies, ref
    share = total['bound_ms'] / total['ms']
    print(f'[6] conv3x3, the 8 of a 32 x 501-frame forward: kernel '
          f'{total["ms"]:.5f} ms ({total["ms"] / 32:.5f} a clip), plain '
          f'{total["plain_ms"]:.5f} ms, library {total["library_ms"]:.5f} '
          f'ms, bound {total["bound_ms"]:.5f} ms ({share:.4f} of it); the '
          f'kernel\'s error at most {worst:.3f} x cuDNN fp32\'s')
    return {**total, 'bound_by': 'operations', 'max_err_vs_cudnn': worst}


def adpcm_kernel_checks(card: str, dev, signals, wires) -> tuple:
    """Phase 10's ADPCM kernel checks: bitwise against its plain version
    on the card for adpcm4/3/2 on the encoded signals, on 32 rows of
    seeded random bytes of each wire width and on their last 31 rows (a
    row slice: an odd start address), then kernel (queued behind a
    spin kernel), plain (CUDA events) and bound at 32 x 80000 and at the
    training shape 256 x 160000.  Returns the largest |kernel - plain|
    and {(bits, rows): (ms, plain ms, bound)}."""
    import numpy as np
    import torch
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.ops import wire as wire_ops
    rng = np.random.RandomState(10)
    err, times = 0.0, {}
    long_x = signals[:64].reshape(32, 160000)            # 10 s clips
    for bits in (4, 3, 2):
        name = f'adpcm{bits}'
        enc10 = (audio_io.adpcm_encode_np(long_x) if bits == 4
                 else audio_io.adpcm_n_encode_np(long_x, bits))
        rand = torch.from_numpy(rng.randint(
            0, 256, (32, wires[name].shape[1])).astype(np.uint8)).to(dev)
        cases = {
            'encoded signals': (torch.from_numpy(wires[name]).to(dev), 80000),
            'random bytes': (rand, 80000),
            'random bytes at an odd address': (rand[1:], 80000),
            '10 s encoded x 8': (torch.from_numpy(np.concatenate(
                [enc10] * 8)).to(dev), 160000)}
        assert rand[1:].data_ptr() % 2 == 1
        for tag, (wav, samples) in cases.items():
            got = wire_ops._adpcm_decode(wav, samples, bits)
            want = wire_ops._adpcm_decode_plain(wav, samples, bits)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), \
                f'{name} {tag}: the ADPCM kernel differs from its plain version'
            err = max(err, (got - want).abs().max().item())
        print(f'[10] {name} kernel bit-exact to its plain version on the '
              f'card: ' + ', '.join(f'{tag} {tuple(cases[tag][0].shape)}'
                                    for tag in cases))
        for rows, (wav, samples) in ((32, (cases['encoded signals'][0][:32],
                                           80000)),
                                     (256, cases['10 s encoded x 8'])):
            ms = queued_ms(lambda: wire_ops._adpcm_decode(wav, samples, bits))
            plain_ms = cuda_ms(lambda: wire_ops._adpcm_decode_plain(
                wav, samples, bits), runs=5)
            bound = adpcm_bound_ms(rows, wav.shape[1], samples, bits)
            times[bits, rows] = (ms, plain_ms, bound)
            print(f'[10] {name} decode of {rows} x {samples} on {card}: '
                  f'kernel {ms!r} ms (20 launches queued behind a spin '
                  f'kernel, CUDA events), plain {plain_ms!r} ms (CUDA events,'
                  f' median of 5); bound {bound[0]!r} ms by {bound[1]} '
                  f'(bytes {bound[3]!r} ms, operations {bound[2]!r} ms); '
                  f'kernel at {bound[0] / ms!r} of it')
    return err, times


TRAIN_BS = 32                      # configs[4]: --batch_size 32
WEAK_BS, STRONG_BS = TRAIN_BS * 3 * 2, TRAIN_BS * 2   # with mixup: 192, 64
PARAM_MAX_DIFF_STEPS = 2.0         # AMSGrad moves an element <= ~lr a step


def train_data(cfg, n: int, seed: int):
    """``n`` bench-corpus clips of 10 s as int16 (the HDF5 path's rows),
    weak targets (class present) and 100 fps strong targets from the
    clips' events."""
    import numpy as np
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.config import LABELS
    clips, events = make_clips(n, cfg.sample_rate, seconds=10, seed=seed,
                               return_events=True)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    weak = np.zeros((n, len(LABELS)), np.float32)
    strong = np.zeros((n, 1000, len(LABELS)), np.float32)
    for i, evs in enumerate(events):
        for e in evs:
            k = LABELS.index(e['event_label'])
            weak[i, k] = 1.0
            strong[i, int(e['onset'] * 100):int(e['offset'] * 100), k] = 1.0
    return pcm, weak, strong


def train_batches(pools, seed: int, weak_bs: int, strong_bs: int):
    """Endless (weak batch, [strong batch]) of numpy rows drawn from the
    pools in a seeded order, with the reference's mixup lambda stream
    (weak, then strong), as ``cli/main_strong.train`` assembles them."""
    import numpy as np
    from sed_tpu_torch.augment.functional import MixupGenerator
    (wpcm, wtarget, _), (spcm, _, sstrong) = pools
    rng = np.random.RandomState(seed)
    mix = MixupGenerator(mixup_alpha=1.0)
    while True:
        wi = rng.choice(len(wpcm), weak_bs, replace=len(wpcm) < weak_bs)
        si = rng.choice(len(spcm), strong_bs, replace=len(spcm) < strong_bs)
        weak = {'waveform': wpcm[wi], 'target': wtarget[wi],
                'mixup_lambda': mix.get_lambda(weak_bs).astype(np.float32)}
        strong = {'waveform': spcm[si], 'strong_target': sstrong[si],
                  'mixup_lambda': mix.get_lambda(strong_bs)
                  .astype(np.float32)}
        yield weak, [strong]


def new_state(model_type, cfg, device, seed: int = 0,
              feature_type: str = 'logmel', compute_dtype=None):
    """A fresh registry model (``init_weights`` from a CPU generator
    seeded ``seed``) on ``device`` with its AMSGrad at lr 1e-3."""
    import torch
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.train.state import create_train_state
    model = get_model(model_type, cfg, feature_type=feature_type,
                      compute_dtype=compute_dtype)
    state = create_train_state(model, 1e-3, torch.Generator().manual_seed(seed))
    model.to(device)
    return state


def state_diff(a, b) -> dict:
    """Parameters, BatchNorm buffers and AMSGrad moments of two train
    states: ``state_dict_diff`` of their models, and each moment's
    largest difference over its tensor's scale (+ 1e-3 of the largest)."""
    out = state_dict_diff(a.model.state_dict(), b.model.state_dict())
    pa = dict(a.model.named_parameters())
    pb = dict(b.model.named_parameters())
    for name in ('mu', 'nu', 'nu_max'):
        ma = {k: a.optimizer.state[p][name].double().cpu()
              for k, p in pa.items()}
        mb = {k: b.optimizer.state[p][name].double().cpu()
              for k, p in pb.items()}
        top = max(v.abs().max().item() for v in mb.values())
        out[name] = max(((ma[k] - mb[k]).abs().max()
                         / (mb[k].abs().max() + 1e-3 * top)).item()
                        for k in ma)
    out['steps'] = (a.step, b.step)
    return out


def state_dict_diff(a: dict, b: dict) -> dict:
    """Two state dicts of one training step: max, mean and share beyond
    1e-5 of the parameter differences, and the BatchNorm buffers' largest
    difference (relative above 1)."""
    import torch

    def d64(k):
        return a[k].double().cpu() - b[k].double().cpu()
    params = [k for k in b if 'running' not in k and 'num_batches' not in k]
    d = torch.cat([d64(k).abs().reshape(-1) for k in params])
    return {'param_max': d.max().item(), 'param_mean': d.mean().item(),
            'param_share_1e-5': (d > 1e-5).double().mean().item(),
            'bn_buffers': max((d64(k).abs() / b[k].double().cpu().abs()
                               .clamp_min(1.0)).max().item()
                              for k in b if 'running' in k),
            'steps': (1, 1)}


# Tolerances of two train states that took the same steps on two
# devices (or with and without a loss scale).  AMSGrad's first update is
# ~lr * sign(g), so an element whose gradient is float noise moves by up
# to 2 lr the other way; after 1 step that is all that differs (measured
# on the H100 against the CPU: 0.03% of the elements beyond 1e-5,
# BatchNorm buffers 3e-7).  Steps 2 and 3 then see slightly different
# weights through BatchNorm over a 4-clip batch, and the differences
# spread (measured: 9% of the elements beyond 1e-5, mean 4.2e-6,
# BatchNorm buffers 6.8e-3, mu 2.7e-2).
STATE_TOL = {1: dict(param_mean=1e-6, share=1e-2, bn=1e-5, moments=0.05),
             3: dict(param_mean=1e-5, share=0.2, bn=2e-2, moments=0.1)}


def check_state_diff(diff: dict, tag: str, phase: int = 13,
                     **tol_override) -> None:
    """``state_diff`` within ``STATE_TOL`` for the states' step count
    (a bound in ``tol_override`` replaces its one); parameters never more
    than 2 lr a step apart."""
    print(f'[{phase}] {tag}: {json.dumps(diff)}')
    steps = diff['steps'][0]
    assert steps == diff['steps'][1], diff
    tol = dict(STATE_TOL[steps], **tol_override)
    assert diff['param_max'] < steps * PARAM_MAX_DIFF_STEPS * 1e-3, diff
    assert diff['param_mean'] < tol['param_mean'], diff
    assert diff['param_share_1e-5'] < tol['share'], diff
    assert diff['bn_buffers'] < tol['bn'], diff
    moments = [diff[k] for k in ('mu', 'nu', 'nu_max') if k in diff]
    assert max(moments, default=0.0) < tol['moments'], diff


# the aten ops whose device time (their kernels') makes each group of a
# train step's breakdown; log-mel is a ctypes launch, found by kernel name
TRAIN_OP_GROUPS = (
    ('conv forward', ('aten::cudnn_convolution',)),
    ('conv backward', ('aten::convolution_backward',)),
    ('BatchNorm', ('aten::cudnn_batch_norm', 'aten::cudnn_batch_norm_backward',
                   'aten::var_mean')),
    ('avg pool', ('aten::avg_pool2d', 'aten::avg_pool2d_backward')),
    ('GRU', ('aten::_cudnn_rnn', 'aten::_cudnn_rnn_backward')),
    ('optimizer', ('aten::_foreach_',)))


# the same for a serving forward of the Conformer family: torch.matmul of
# 4-D tensors is aten::bmm (the attention products), nn.Linear aten::addmm
# or aten::mm
SERVE_OP_GROUPS = (
    ('conv stack', ('aten::cudnn_convolution',)),
    ('depthwise conv', ('aten::_conv_depthwise2d',)),
    ('BatchNorm', ('aten::cudnn_batch_norm', 'aten::native_batch_norm')),
    ('avg pool', ('aten::avg_pool2d',)),
    ('linear layers', ('aten::addmm', 'aten::mm')),
    ('attention products', ('aten::bmm',)),
    ('softmax', ('aten::_softmax',)),
    ('LayerNorm', ('aten::native_layer_norm',)))


def profile_by_group(fn, groups, tag: str, what: str, top: int = 15) -> dict:
    """Profiler breakdown of one ``fn()``: wall, device kernel time, the
    device's idle share, device time by group (the kernels each aten op
    of ``groups`` launched, log-mel by kernel name, the rest as 'other')
    and the top kernels.  Returns the groups' device time in us.

    ``fn`` runs twice inside one trace and only the second call is
    reported (the events that start after its marker): a profile taken
    after earlier ones in the same process lost the first kernels of its
    trace (log-mel, ``bn0``, the first convolution), and can lose every
    launch of a call that makes only one or two (``graph_launches``
    counts those)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    marker = 'chip_smoke::measured'
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(marker):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = next(e for e in events if e.name == marker).time_range.start
    events = [e for e in events if e.time_range.start >= start]
    kernels = collections.defaultdict(lambda: [0.0, 0])   # name: us, count
    for e in events:
        # the marker itself comes back as a device annotation per stream
        if e.device_type == DeviceType.CUDA and e.name != marker:
            kernels[e.name][0] += e.self_device_time_total
            kernels[e.name][1] += 1
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    busy_us = sum(us for _, (us, _) in rows)
    by = {name: sum(e.device_time_total for e in events
                    if e.device_type == DeviceType.CPU
                    and any(e.name == op or (op.endswith('_')
                                             and e.name.startswith(op))
                            for op in ops))
          for name, ops in groups}
    by['log-mel'] = sum(us for name, (us, _) in rows if 'logmel' in name)
    by['other'] = busy_us - sum(by.values())
    n_kernels = sum(count for _, (_, count) in rows)
    print(f'[{tag}] profile of {what}: wall {wall_us:.0f} us, device '
          f'kernels {busy_us:.0f} us in {n_kernels} launches, device idle '
          f'share {1 - busy_us / wall_us:.3f}; device time by op (us): '
          + ', '.join(f'{k} {v:.0f}' for k, v in sorted(
              by.items(), key=lambda kv: -kv[1])))
    for name, (us, count) in rows[:top]:
        print(f'[{tag}]   {us:10.0f} us  x{count:<4d} {name[:90]}')
    by['busy'] = busy_us
    by['launches'] = n_kernels
    return by


def profile_train_step(step_fn, batch, generator, tag: str) -> None:
    """``profile_by_group`` of one train step."""
    profile_by_group(lambda: step_fn(batch[0], batch[1], generator),
                     TRAIN_OP_GROUPS, tag, 'one train step')


def train_phase(card: str, dev, cfg, pcm):
    """Phase 13; returns the kernel launches of the timed training run
    and, per training batch, the kernel's (ms, plain ms, bound, max
    |kernel - plain|)."""
    import argparse
    import numpy as np
    import torch
    from sed_tpu_torch.cli import common
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.dsp.frontend import logmel_plain
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    from sed_tpu_torch.train.checkpoint import save_best_checkpoint
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.step import LossScaleState, init_loss_scale
    from sed_tpu_torch.utils.paths import Workspace
    model_type = 'Cnn_9layers_Gru_FrameAtt'
    pools = train_pools(cfg)

    def step_for(state, **kw):
        return train_step(state, cfg, **kw)

    # the kernel at the training shapes
    out = {}
    for n in (WEAK_BS, STRONG_BS):
        wav = torch.from_numpy(pools[0 if n == WEAK_BS else 1][0][:n]).to(
            dev).float() / 32767.0
        times, err, frames = time_kernel(fused_logmel, logmel_plain, wav, cfg,
                                         f64=True)
        bound = bound_ms(cfg, tuple(wav.shape), frames)
        out[n] = (min(times['kernel']), min(times['plain']), bound, err)
        print(f'[13] log-mel {cfg.name} {n} x {wav.shape[1]} ({frames} '
              f'frames) on {card}: kernel {times["kernel"]} ms, plain '
              f'{times["plain"]} ms (median of 20 each, in turns); bound '
              f'{bound[0]:.5f} ms by {bound[1]} (operations {bound[2]:.5f}, '
              f'bytes {bound[3]:.5f}); kernel at {bound[0] / out[n][0]:.4f} '
              f'of it; max |kernel - plain| {err!r} dB')
        del wav

    # the timed run: configs[4] at full width and depth
    state = new_state(model_type, cfg, dev)
    step_fn = step_for(state)
    generator = torch.Generator(device=dev).manual_seed(1234)
    batches = device_prefetch(train_batches(pools, 7, WEAK_BS, STRONG_BS),
                              size=2, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_logmel.launches = 0
    reset_conv_counts()
    losses = []
    for i in range(25):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        weak, strong = next(batches)
        losses.append(step_fn(weak, strong, generator)['loss'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_logmel.launches
    check_epilogues('[13] training', state.model, 0)
    losses = torch.stack(losses).cpu()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f'[13] train {model_type} on {card}: weak {WEAK_BS} + strong '
          f'{STRONG_BS} clips of 10 s a step, specaugment_timeshift_mixup; '
          f'20 timed steps (after 5) in {wall:.3f} s: '
          f'{20 / wall:.3f} steps/s, {20 * (WEAK_BS + STRONG_BS) / wall:.1f} '
          f'clips/s; peak memory {peak / 2**30:.2f} GiB; log-mel kernel '
          f'launches {launches} (25 steps); losses {losses.tolist()}')
    assert torch.isfinite(losses).all(), 'a training loss is not finite'
    assert launches == 2 * 25, f'{launches} kernel launches in 25 steps'
    assert state.step == 25
    profile_train_step(step_fn, next(batches), generator, '13')
    batches.close()

    # GPU against CPU: the same initial weights and batches
    small = train_batches(pools, 3, 8, 4)
    sb = [next(small) for _ in range(3)]
    states = {d: new_state(model_type, cfg, d) for d in (dev, 'cpu')}
    steps = {d: step_for(s, augment=False) for d, s in states.items()}

    def to(batch, d):
        return {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
    for i, (weak, strong) in enumerate(sb):
        got = {d: steps[d](to(weak, d), [to(strong[0], d)],
                           torch.Generator(device=d).manual_seed(i))
               for d in states}
        lg, lc = got[dev]['loss'].item(), got['cpu']['loss'].item()
        print(f'[13] step {i + 1} loss GPU {lg!r} CPU {lc!r}')
        assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
        if i in (0, 2):
            check_state_diff(state_diff(states[dev], states['cpu']),
                             f'GPU - CPU after {i + 1} step(s)')

    # loss scaling: a static scale against the unscaled step, then an inf
    a, b = new_state(model_type, cfg, dev), new_state(model_type, cfg, dev)
    weak, strong = to(sb[0][0], dev), to(sb[0][1][0], dev)
    ma = step_for(a, augment=False)(weak, [strong], None)
    mb = step_for(b, augment=False, loss_scale=1024.0)(weak, [strong], None)
    assert mb['grads_finite'] and ma['loss'].item() == mb['loss'].item()
    check_state_diff(state_diff(a, b), 'static scale 1024 - unscaled')
    scaled = step_for(b, augment=False, loss_scale='dynamic')
    before = {k: v.clone() for k, v in b.model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in b.optimizer.state[p]
                          .items() if torch.is_tensor(v)}
                  for p in b.model.parameters()}
    bad = dict(weak, waveform=weak['waveform'].float() / 32767.0)
    bad['waveform'][0, 0] = float('inf')
    m, ss = scaled(bad, [strong], None, init_loss_scale())
    assert not m['grads_finite'] and b.step == 1
    assert ss == LossScaleState(2.0 ** 11, 0), ss
    assert all(torch.equal(v, before[k])
               for k, v in b.model.state_dict().items())
    assert all(torch.equal(v, opt_before[id(p)][k])
               for p in b.model.parameters()
               for k, v in b.optimizer.state[p].items() if torch.is_tensor(v))
    print('[13] loss scaling: static 1024 step = unscaled step (loss '
          'bitwise); inf in the batch: step skipped, parameters, AMSGrad '
          'state, step and BatchNorm buffers bit-identical, scale 4096 -> '
          f'{ss.scale}')

    # the Transformer, dropout on
    tstate = new_state('Cnn_9layers_Transformer_FrameAtt', cfg, dev)
    tstep = step_for(tstate)
    tb = train_batches(pools, 11, WEAK_BS, STRONG_BS)
    tl = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        weak, strong = next(tb)
        tl.append(tstep(to(weak, dev), [to(strong[0], dev)], generator)
                  ['loss'].item())
    print(f'[13] Transformer 5 steps at weak {WEAK_BS} + strong {STRONG_BS} '
          f'on {card}: losses {tl}, {5 / (time.perf_counter() - t0):.3f} '
          f'steps/s (host uploads included)')
    assert np.isfinite(tl).all()
    del tstate, tstep

    # checkpoint round trip through the CLI's resolution
    with tempfile.TemporaryDirectory() as tmp:
        args = argparse.Namespace(checkpoint=None, feature_type='logmel',
                                  model_type=model_type)
        ws = Workspace(root=tmp, model_type=model_type)
        saved = save_best_checkpoint(ws.checkpoint_path('logmel', cfg.name,
                                                        create=True), state)
        path = common.checkpoint_path(args, cfg, ws)
        assert path == saved, (path, saved)
        loaded = load_checkpoint(path, model_type, cfg, dev)
    got = SedInferenceEngine(loaded, cfg, dev, batch_size=32).predict_clips(pcm)
    want = SedInferenceEngine(state.model, cfg, dev,
                              batch_size=32).predict_clips(pcm)
    assert got == want, 'the saved checkpoint predicts other events'
    print(f'[13] {os.path.basename(path)} -> checkpoint_path -> '
          f'load_checkpoint -> predict_clips on 64 clips: '
          f'{sum(map(len, got[0]))} events, events and XML equal to the '
          'trained model in memory')
    return launches, out


FAMILY_NAMES = (
    'Cnn_9layers_Conformer_FrameAtt', 'Cnn_9layers_Conformer_FrameAvg',
    'Cnn_14layers_Conformer_FrameAtt', 'Cnn_7layers_Conformer',
    'Cnn_9layers_Conformer', 'VGGish_FrameAtt', 'VGGish_Gru_FrameAtt',
    'VGGish_FrameAvg', 'Cnn14_DecisionLevelAtt')
# the token-pooling Conformers put out logits
LOGIT_MODELS = ('Cnn_7layers_Conformer', 'Cnn_9layers_Conformer')
# 3x3 launches on packed tiles in a forward of 32 5 s clips: the
# six-block stacks' blocks 5-6 (31 x 4 and 15 x 2 planes, 2 and 8 images a
# tile); every other name's planes take one image a tile
PACKED_A_FORWARD = {'Cnn_14layers_Conformer_FrameAtt': 4,
                    'Cnn14_DecisionLevelAtt': 4}
# Seeded weights leave many (clip, class) tracks with probabilities at a
# threshold (CNN14's all lie within 0.02 of 0.5), where a float32
# difference of 1e-6 between the card and the CPU moves an onset or
# makes or drops an event.  So events are compared as multisets and the
# share that differs is bounded.
EVENT_DIFF_SHARE = 0.02


def event_diff(a, b) -> tuple:
    """(events of ``a`` and ``b`` that the other side lacks, events of
    ``a``): per-clip event lists as multisets of (clip, label, onset,
    offset)."""
    import collections

    def bag(per_clip):
        return collections.Counter(
            (i, e['event_label'], round(e['onset'], 4),
             round(e['offset'], 4))
            for i, evs in enumerate(per_clip) for e in evs)
    ca, cb = bag(a), bag(b)
    return (sum(((ca - cb) + (cb - ca)).values()), sum(ca.values()))


def check_events(tag, got, want) -> str:
    """Bounded ``event_diff`` of two per-clip event lists; the phrase to
    print."""
    differ, total = event_diff(got, want)
    assert total > 0, f'{tag}: no events'
    assert differ <= max(2, EVENT_DIFF_SHARE * total), \
        f'{tag}: {differ} of {total} events differ between GPU and CPU'
    return (f'{total} events identical to the CPU' if not differ else
            f'{total} events, {differ} differ from the CPU (bound '
            f'{max(2, int(EVENT_DIFF_SHARE * total))})')


def zero_dropouts(model) -> int:
    """Set every dropout rate of ``model`` (a float attribute with
    'dropout' in its name) to 0; returns how many there were."""
    n = 0
    for m in model.modules():
        for attr, value in list(vars(m).items()):
            if 'dropout' in attr and isinstance(value, float):
                setattr(m, attr, 0.0)
                n += 1
    return n


def families_phase(card: str, dev, cfg, pcm) -> int:
    """Phase 14; returns the kernel launches of its main-path runs."""
    import argparse
    import copy
    import numpy as np
    import torch
    from sed_tpu_torch import config
    from sed_tpu_torch import losses as losses_lib
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.cli import common
    from sed_tpu_torch.compat.bench_weights import seeded_model
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import SedInferenceEngine, window_starts
    from sed_tpu_torch.serve.streaming import StreamingSed
    from sed_tpu_torch.train.checkpoint import save_best_checkpoint
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.state import create_train_state
    from sed_tpu_torch.train.step import make_train_step
    from sed_tpu_torch.utils.paths import Workspace
    total_launches = 0

    def engines(name, rate, **kw):
        model = seeded_model(name, rate, seed=0)
        kw = dict(dict(batch_size=32), **kw)
        return (SedInferenceEngine(copy.deepcopy(model), rate, dev, **kw),
                SedInferenceEngine(model, rate, 'cpu', **kw))

    # -- serving, each of the nine names, and CNN14 at 32 kHz -------------
    pcm32 = (np.clip(make_clips(64, config.AUDIO_32K.sample_rate, seconds=5,
                                seed=0), -1, 1) * 32767).astype(np.int16)
    served = [(name, cfg, pcm) for name in FAMILY_NAMES] + [
        ('Cnn14_DecisionLevelAtt', config.AUDIO_32K, pcm32)]
    kept = {}
    for name, rate, clips in served:
        t0 = time.perf_counter()
        gpu, cpu = engines(name, rate)
        fused_logmel.launches = 0
        reset_conv_counts()
        ev_gpu, xml_gpu = gpu.predict_clips(clips)
        launched = fused_logmel.launches
        assert launched > 0, f'{name} did not launch the log-mel kernel'
        check_epilogues(f'[14] {name}', gpu.model, launched,
                        PACKED_A_FORWARD.get(name, 0) * launched)
        total_launches += launched
        ev_cpu, xml_cpu = cpu.predict_clips(clips)
        events = check_events(name, ev_gpu, ev_cpu)
        if ev_gpu == ev_cpu:
            assert xml_gpu == xml_cpu, f'{name}: XML differs, events do not'
        fw_gpu, cw_gpu = gpu.infer_framewise(clips)
        fw_cpu, cw_cpu = cpu.infer_framewise(clips)
        assert fw_gpu.shape == fw_cpu.shape == (64, gpu._out_frames, 25)
        assert np.isfinite(fw_gpu).all() and np.isfinite(cw_gpu).all()
        scale = (lambda x: np.maximum(1.0, np.abs(x))) \
            if name in LOGIT_MODELS else (lambda x: 1.0)
        fw_err = float((np.abs(fw_gpu - fw_cpu) / scale(fw_cpu)).max())
        cw_err = float((np.abs(cw_gpu - cw_cpu) / scale(cw_cpu)).max())
        rates, _ = clips_per_s(gpu, np.concatenate([clips] * 8))
        print(f'[14] {name} ({rate.name}) predict_clips on {card}: 64 '
              f'clips, {gpu._out_frames} frames a clip, {events}, log-mel '
              f'kernel launches {launched} (3x3 {conv3x3_launches[-1]}, '
              f'{conv3x3_packed[-1]} of them packed, '
              f'epilogue {epilogue_launches[-1]}); max |framewise gpu - cpu| '
              f'= {fw_err!r}, clipwise {cw_err!r}'
              + (' (logits, over max(1, |x|))' if name in LOGIT_MODELS
                 else '')
              + f'; 512 int16 clips at batch 32: '
              f'{[round(r, 1) for r in rates]} clips/s (3 runs); '
              f'{time.perf_counter() - t0:.1f} s for the name')
        assert fw_err <= FRAMEWISE_ATOL and cw_err <= FRAMEWISE_ATOL, name
        if name in ('Cnn_9layers_Conformer_FrameAtt',
                    'Cnn_9layers_Conformer'):
            kept[name] = (gpu, cpu)
            by = profile_by_group(
                lambda: gpu.predict_clips(clips[:32]), SERVE_OP_GROUPS, '14',
                f'{name} predict_clips(32 clips)', top=12)
            assert by['log-mel'] > 0, 'the profile lacks the log-mel kernel'
            attention = by['attention products'] + by['softmax']
            print(f'[14] {name}: attention products + softmax '
                  f'{attention:.0f} us = {attention / by["busy"]:.4f} of the '
                  f'device time of a batch')
        del gpu, cpu
        torch.cuda.empty_cache()

    # -- the Conformer windowed and streamed, GPU vs CPU ------------------
    name = 'Cnn_9layers_Conformer_FrameAtt'
    gpu, cpu = kept.pop(name)
    kept.clear()
    clips10 = make_clips(16, cfg.sample_rate, seconds=10, seed=21)
    names10 = [f'clip{i}_0.wav' for i in range(len(clips10))]
    step, window = 0.5, 6
    kw = dict(sample_duration=window, overlap=True, overlap_value=step,
              batch_size=32)
    wgpu = SedInferenceEngine(gpu.model, cfg, dev, **kw)
    wcpu = SedInferenceEngine(cpu.model, cfg, 'cpu', **kw)
    fused_logmel.launches = 0
    reset_conv_counts()
    ev_gpu = wgpu.predict_clips_windowed(clips10, names10, 10.0, step)
    launched = fused_logmel.launches
    assert launched > 0, 'the Conformer windowed path launched no kernel'
    check_epilogues('[14] windowed', wgpu.model, launched)
    total_launches += launched
    events = check_events('windowed', ev_gpu, wcpu.predict_clips_windowed(
        clips10, names10, 10.0, step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wgpu.predict_clips_windowed(clips10, names10, 10.0, step)
    rate = len(clips10) / (time.perf_counter() - t0)
    print(f'[14] {name} windowed [{step}, {window}] on {card}: '
          f'{len(window_starts(10.0, window, True, step))} windows a clip, '
          f'16 clips of 10 s, {events}, kernel launches {launched}; '
          f'{rate:.1f} clips/s (second run)')

    stream = make_clips(6, cfg.sample_rate, seconds=5, seed=31).reshape(-1)
    rng = np.random.RandomState(12)
    sess = StreamingSed(gpu, 'stream')
    fused_logmel.launches = 0
    reset_conv_counts()
    pos, feeds, got = 0, 0, []
    while pos < len(stream):
        size = int(rng.uniform(0.05, 3.0) * cfg.sample_rate)
        got.extend(sess.feed(stream[pos:pos + size]))
        pos += size
        feeds += 1
    early = len(got)
    got += sess.flush()
    launched = fused_logmel.launches
    assert launched > 0, 'the Conformer stream did not launch the kernel'
    check_epilogues('[14] stream', gpu.model, launched)
    total_launches += launched
    events = check_events('stream', [got],
                          [cpu.predict_waveform(stream, 'stream')])
    print(f'[14] {name} StreamingSed on {dev}: 30 s in {feeds} random '
          f'chunks, {events} ({early} before the flush; the CPU side is '
          f'predict_waveform); kernel launches {launched}')
    del gpu, cpu, wgpu, wcpu, sess
    torch.cuda.empty_cache()

    # -- training: BCE losses and logits losses ---------------------------
    pools = train_pools(cfg)

    def to(batch, d):
        return {k: torch.from_numpy(v).to(d) for k, v in batch.items()}

    for name in ('Cnn_9layers_Conformer_FrameAtt', 'Cnn_7layers_Conformer'):
        kind = '_logits' if name in LOGIT_MODELS else ''

        def step_for(state, augment=True):
            return make_train_step(
                state.model, state.optimizer,
                losses_lib.get_loss_func('clip_bce' + kind),
                losses_lib.get_loss_func('frame_bce' + kind), mixup=True,
                timeshift=augment, spec_augment=augment,
                wire_samples=cfg.audio_samples)

        state = new_state(name, cfg, dev)
        step_fn = step_for(state)
        generator = torch.Generator(device=dev).manual_seed(1234)
        batches = device_prefetch(train_batches(pools, 7, WEAK_BS, STRONG_BS),
                                  size=2, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fused_logmel.launches = 0
        reset_conv_counts()
        losses = []
        for i in range(12):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            weak, strong = next(batches)
            losses.append(step_fn(weak, strong, generator)['loss'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = fused_logmel.launches
        check_epilogues(f'[14] train {name}', state.model, 0)
        total_launches += launched
        losses = torch.stack(losses).cpu()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f'[14] train {name} (clip_bce{kind} + frame_bce{kind}) on '
              f'{card}: weak {WEAK_BS} + strong {STRONG_BS} clips of 10 s a '
              f'step, specaugment_timeshift_mixup; 10 timed steps (after 2) '
              f'in {wall:.3f} s: {10 / wall:.3f} steps/s, '
              f'{10 * (WEAK_BS + STRONG_BS) / wall:.1f} clips/s; peak memory '
              f'{peak / 2**30:.2f} GiB; log-mel kernel launches {launched} '
              f'(12 steps); losses {losses.tolist()}')
        assert torch.isfinite(losses).all(), f'{name}: a loss is not finite'
        assert losses[-3:].mean() < losses[:3].mean(), \
            f'{name}: the losses do not fall'
        assert launched == 2 * 12 and state.step == 12
        profile_by_group(
            lambda b=next(batches): step_fn(b[0], b[1], generator),
            TRAIN_OP_GROUPS + SERVE_OP_GROUPS[4:], '14',
            f'one train step of {name}', top=8)
        batches.close()

        # one step GPU = CPU: the same initial weights and batch, every
        # dropout rate 0, SpecAugment and timeshift off
        states = {d: new_state(name, cfg, d) for d in (dev, 'cpu')}
        weak, strong = next(train_batches(pools, 3, 8, 4))
        got = {}
        for d, st in states.items():
            assert zero_dropouts(st.model) >= 6
            got[d] = step_for(st, augment=False)(
                to(weak, d), [to(strong[0], d)],
                torch.Generator(device=d).manual_seed(0))['loss'].item()
        print(f'[14] {name} step 1 loss GPU {got[dev]!r} CPU {got["cpu"]!r}')
        assert abs(got[dev] - got['cpu']) <= 1e-4 * abs(got['cpu'])
        # moments 0.15, not 0.05: the biases of the convolutions in front
        # of a training-mode BatchNorm (the baseline CNN's, the depthwise
        # conv's) have an exactly zero gradient, so their first moment is
        # float noise on either device (measured 0.03 of the scale)
        check_state_diff(state_diff(states[dev], states['cpu']),
                         f'{name} GPU - CPU after 1 step', phase=14,
                         moments=0.15)
        del states

        # the trained model's checkpoint through the CLI's resolution
        with tempfile.TemporaryDirectory() as tmp:
            args = argparse.Namespace(checkpoint=None, feature_type='logmel',
                                      model_type=name)
            ws = Workspace(root=tmp, model_type=name)
            saved = save_best_checkpoint(
                ws.checkpoint_path('logmel', cfg.name, create=True), state)
            path = common.checkpoint_path(args, cfg, ws)
            assert path == saved, (path, saved)
            loaded = load_checkpoint(path, name, cfg, dev)
        e_loaded = SedInferenceEngine(loaded, cfg, dev, batch_size=32)
        e_memory = SedInferenceEngine(state.model, cfg, dev, batch_size=32)
        got = e_loaded.predict_clips(pcm)
        assert got == e_memory.predict_clips(pcm), \
            f'{name}: the saved checkpoint predicts other events'
        # few events after 13 steps, so the framewise output too
        fw_err = float(np.abs(e_loaded.infer_framewise(pcm)[0]
                              - e_memory.infer_framewise(pcm)[0]).max())
        assert fw_err <= 1e-6, (name, fw_err)
        print(f'[14] {name} {os.path.basename(path)} -> checkpoint_path -> '
              f'load_checkpoint -> predict_clips on 64 clips: '
              f'{sum(map(len, got[0]))} events, events and XML equal to the '
              f'trained model in memory, max |framewise| difference '
              f'{fw_err!r}')
        del state, step_fn, loaded, e_loaded, e_memory
        torch.cuda.empty_cache()
    return total_launches


GAMMA_POOL = (96, 32)     # weak and strong clips a rate; batches draw rows


def gamma_pools(cfg, seed: int):
    """Phase 13's weak and strong pools with each 10 s clip replaced by
    its packed gammatone features (numpy ``fft_gtgram_db(...).astype(
    np.int16)``, as ``data/hdf5_pack.py`` writes them; the card has no
    h5py, so nothing is packed to a file).  Returns the pools and the
    host seconds a clip took to pack."""
    import numpy as np
    from sed_tpu_torch.dsp import gammatone as gt
    pools, seconds, clips = [], 0.0, 0
    for i, n in enumerate(GAMMA_POOL):
        pcm, weak, strong = train_data(cfg, n, seed=seed + i)
        t0 = time.perf_counter()
        feats = np.stack([gt.fft_gtgram_db(row / 32767.0, cfg)
                          .astype(np.int16) for row in pcm])
        seconds += time.perf_counter() - t0
        clips += n
        pools.append((feats, weak, strong))
    return tuple(pools), seconds / clips


def gamma_phase(card: str, dev) -> None:
    """Phase 15: ``BASELINE.json`` ``configs[3]`` (the gammatone feature)
    and the other frontends on the card."""
    import argparse
    import copy
    import numpy as np
    import torch
    from sed_tpu_torch import config, losses as losses_lib
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.cli import common
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.dsp import filters, gammatone as gt, transforms
    from sed_tpu_torch.dsp.cqt import CQTFrontend
    from sed_tpu_torch.dsp.frontend import stft
    from sed_tpu_torch.eval.evaluator import Evaluator
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.train.checkpoint import save_best_checkpoint
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.step import make_train_step
    from sed_tpu_torch.utils.paths import Workspace
    model_type = 'Cnn_9layers_Gru_FrameAtt'

    def step_for(state, augment=True):
        return make_train_step(state.model, state.optimizer,
                               losses_lib.clip_bce, losses_lib.frame_bce,
                               mixup=True, timeshift=augment,
                               spec_augment=augment)

    states = {}
    for cfg in (config.AUDIO_8K, config.AUDIO_16K, config.AUDIO_32K):
        # (a) feature pools and fft_gtgram_batch on the card
        pools, pack_s = gamma_pools(cfg, seed=151)
        frames = pools[0][0].shape[-1]
        assert frames == gt.gtgram_frames(cfg, cfg.audio_samples) == 994
        args = (cfg.sample_rate, cfg.window_size / cfg.sample_rate,
                cfg.hop_size / cfg.sample_rate, cfg.mel_bins, cfg.fmin)
        clips = make_clips(32, cfg.sample_rate, seconds=10, seed=153)
        wav = torch.from_numpy(clips).to(dev)
        got = gt.fft_gtgram_batch(wav, *args).cpu().numpy()
        t0 = time.perf_counter()
        gold = [gt.fft_gtgram(c.astype(np.float64), *args) for c in clips[:4]]
        np_ms = (time.perf_counter() - t0) / 4 * 1e3
        err = max(float(np.abs(g - w).max() / np.abs(w).max())
                  for g, w in zip(got, gold))
        assert got.shape == (32, cfg.mel_bins, frames)
        # fp32 sums of n_fft products (512-2048); measured on the H100
        # 1.3e-6 / 2.3e-6 / 6.1e-6 at 8 / 16 / 32 kHz
        assert err <= 2e-5, f'fft_gtgram_batch off float64 by {err}'
        ms = cuda_ms(lambda: gt.fft_gtgram_batch(wav, *args))
        print(f'[15] {cfg.name}: packed {sum(GAMMA_POOL)} clips of 10 s to '
              f'int16 (64, {frames}) gammatone features on the host, '
              f'{pack_s * 1e3:.1f} ms a clip; fft_gtgram_batch of 32 x '
              f'{clips.shape[1]} on {card}: {ms:.4f} ms (median of 20), '
              f'numpy float64 fft_gtgram {np_ms:.1f} ms a clip x 32 = '
              f'{np_ms * 32:.1f} ms; max |card - float64| {err!r} of each '
              "clip's largest value")
        del wav

        # (b) configs[3]: train at full width and depth
        state = new_state(model_type, cfg, dev, feature_type='gamma')
        step_fn = step_for(state)
        generator = torch.Generator(device=dev).manual_seed(1234)
        batches = device_prefetch(train_batches(pools, 7, WEAK_BS, STRONG_BS),
                                  size=2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_logmel.launches = 0
        reset_conv_counts()
        losses = []
        for i in range(13):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            weak, strong = next(batches)
            losses.append(step_fn(weak, strong, generator)['loss'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_logmel.launches
        check_epilogues('[15] gamma training', state.model, 0)
        losses = torch.stack(losses).cpu()
        peak = torch.cuda.max_memory_allocated(dev)
        upload = sum(v.nbytes for v in (weak['waveform'],
                                        strong[0]['waveform']))
        print(f'[15] train {model_type} gamma {cfg.name} on {card}: weak '
              f'{WEAK_BS} + strong {STRONG_BS} int16 (64, {frames}) feature '
              f'rows a step ({upload / 1e6:.1f} MB of features uploaded a '
              f'step), specaugment_timeshift_mixup; 10 timed steps (after 3) '
              f'in {wall:.3f} s: {10 / wall:.3f} steps/s, '
              f'{10 * (WEAK_BS + STRONG_BS) / wall:.1f} clips/s; peak memory '
              f'{peak / 2**30:.2f} GiB; log-mel kernel launches {launches}; '
              f'losses {losses.tolist()}')
        assert torch.isfinite(losses).all(), 'a gamma loss is not finite'
        assert launches == 0, f'the gamma path launched log-mel {launches}x'
        assert state.step == 13
        if cfg is config.AUDIO_16K:
            profile_train_step(step_fn, next(batches), generator, '15')
            states[cfg.name] = (state, pools)
        batches.close()
        del step_fn, batches, weak, strong
        torch.cuda.empty_cache()

    # (c) GPU against CPU at 16 kHz
    cfg = config.AUDIO_16K
    state, pools = states['16k']
    weak, strong = next(train_batches(pools, 3, 8, 4))
    pair = {d: new_state(model_type, cfg, d, feature_type='gamma')
            for d in (dev, 'cpu')}

    def to(batch, d):
        return {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
    got = {d: step_for(s, augment=False)(
        to(weak, d), [to(strong[0], d)],
        torch.Generator(device=d).manual_seed(0)) for d, s in pair.items()}
    lg, lc = got[dev]['loss'].item(), got['cpu']['loss'].item()
    print(f'[15] gamma step loss GPU {lg!r} CPU {lc!r}')
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    check_state_diff(state_diff(pair[dev], pair['cpu']),
                     'gamma GPU - CPU after 1 step', phase=15)
    del pair

    feats = pools[0][0][:32]
    names = [f'gamma{i}_0.wav' for i in range(32)]
    loader = [{'audio_name': np.array(names[i:i + 12]),
               'waveform': feats[i:i + 12]} for i in range(0, 32, 12)]
    fused_logmel.launches = 0
    reset_conv_counts()
    out_gpu = Evaluator(state.model, dev).forward(loader)
    assert fused_logmel.launches == 0
    check_epilogues('[15] gamma Evaluator', state.model, len(loader))
    out_cpu = Evaluator(copy.deepcopy(state.model).cpu(),
                        'cpu').forward(loader)
    assert out_gpu['framewise_output'].shape == (32, 1000, 25)
    e_err = float(np.abs(out_gpu['framewise_output']
                         - out_cpu['framewise_output']).max())
    print(f'[15] Evaluator forward of the trained gamma model on {dev}: 32 '
          f'packed clips in batches of 12/12/8, max |framewise gpu - cpu| = '
          f'{e_err!r}')
    assert e_err <= FRAMEWISE_ATOL
    with tempfile.TemporaryDirectory() as tmp:
        args = argparse.Namespace(checkpoint=None, feature_type='gamma',
                                  model_type=model_type)
        ws = Workspace(root=tmp, model_type=model_type)
        saved = save_best_checkpoint(ws.checkpoint_path('gamma', cfg.name,
                                                        create=True), state)
        path = common.checkpoint_path(args, cfg, ws)
        assert path == saved, (path, saved)
        loaded = load_checkpoint(path, model_type, cfg, dev,
                                 feature_type='gamma')
    out_loaded = Evaluator(loaded, dev).forward(loader)
    assert np.array_equal(out_loaded['framewise_output'],
                          out_gpu['framewise_output'])
    print(f'[15] {os.path.relpath(path, tmp)} -> checkpoint_path -> '
          'load_checkpoint(feature_type=gamma) -> Evaluator forward: equal '
          'to the trained model in memory')
    del state, loaded, states
    torch.cuda.empty_cache()

    # (d) CQTFrontend, 32 x 5 s at 16 kHz
    clips = torch.from_numpy(make_clips(32, cfg.sample_rate, seconds=5,
                                        seed=157))
    fe_gpu = CQTFrontend(cfg)
    x = clips.to(dev)
    c_gpu = fe_gpu(x).cpu().double()
    c_cpu = CQTFrontend(cfg, device='cpu')(clips).double()
    c_f64 = CQTFrontend(cfg, device='cpu').double()(clips.double())
    errs = [(c - c_f64).abs().max().item() for c in (c_gpu, c_cpu)]
    c_ms = cuda_ms(lambda: fe_gpu(x))
    print(f'[15] CQTFrontend 32 x 80000 on {card}: {tuple(c_gpu.shape)}, max '
          f'|GPU - float64| {errs[0]!r} dB, |CPU - float64| {errs[1]!r} dB; '
          f'{c_ms:.4f} ms (median of 20)')
    # float32 power sums cancel in the faint lowest bins on both devices
    assert errs[0] <= errs[1] + 1e-2, 'the card is off float64 beyond the CPU'

    # (e) istft(stft(x)) on the card
    mat = torch.from_numpy(filters.stft_matrices(cfg.window_size)).float()
    re, im = stft(x, mat.to(dev), cfg.hop_size)
    back = transforms.istft(re, im, cfg.window_size, cfg.hop_size,
                            length=x.shape[1])
    i_err = (back - x).abs().max().item()
    i_ms = cuda_ms(lambda: transforms.istft(re, im, cfg.window_size,
                                            cfg.hop_size, length=x.shape[1]))
    print(f'[15] istft(stft(x)) of 32 x 80000 on {card}: max |x - back| '
          f'{i_err!r}; istft {i_ms:.4f} ms (median of 20)')
    assert back.is_cuda and i_err <= 2e-3


@functools.lru_cache(maxsize=None)
def train_pools(cfg) -> tuple:
    """Phase 13's pools: weak and strong ``train_data`` of 192 and 64
    clips, made once a process."""
    return (train_data(cfg, WEAK_BS, seed=51),
            train_data(cfg, STRONG_BS, seed=52))


def train_step(state, cfg, mixup=True, augment=True, loss_scale=None,
               group=None):
    """The joint step of ``state`` with phase 13's losses (clip_bce,
    frame_bce) and augmentation (mixup; with ``augment`` timeshift and
    SpecAugment), int16 wire; ``group`` makes it data-parallel."""
    from sed_tpu_torch import losses as losses_lib
    from sed_tpu_torch.train.step import make_train_step
    return make_train_step(
        state.model, state.optimizer, losses_lib.clip_bce,
        losses_lib.frame_bce, mixup=mixup, timeshift=augment,
        spec_augment=augment, loss_scale=loss_scale,
        wire_samples=cfg.audio_samples, group=group)


# the bf16 serving gate, sed_tpu's own (tests/test_serve.py:796-852):
# framewise within 0.05 of the float32 engine, events (label, onset and
# offset within 0.05 s) matched both ways for at least 90%
BF16_FRAMEWISE_ATOL = 0.05
BF16_EVENT_TOL_S = 0.05
BF16_EVENT_SHARE = 0.9
# "train correct" for bf16 (PERF.md §2): each of 25 steps' loss of the
# bf16 run (dynamic loss scale) within this share of the float32 run's
# from the same init, batches and generator.  Set from two CPU runs (weak
# 12 + strong 4 rows a step, mixup, SpecAugment and timeshift on) before
# the first card run: at most 1.7e-3 (conv channels 16-128, GRU 64, 2 s
# clips) and 9.3e-3 (full width, 1 s clips) over 25 steps.
BF16_LOSS_RTOL = 2e-2
# casts to and from bf16 (and host uploads) in a profile by op group
CAST_GROUP = (('casts and copies', ('aten::_to_copy',)),)


def event_match(a, b, tol: float = BF16_EVENT_TOL_S) -> float:
    """Share of the events of two per-clip lists that have an event of the
    same clip and label on the other side with onset and offset within
    ``tol`` s, counted both ways."""
    def flat(per_clip):
        return [(i, e['event_label'], e['onset'], e['offset'])
                for i, evs in enumerate(per_clip) for e in evs]

    def matched(src, dst):
        return sum(any(j == i and lb2 == lb and abs(on2 - on) <= tol
                       and abs(off2 - off) <= tol
                       for j, lb2, on2, off2 in dst)
                   for i, lb, on, off in src)
    fa, fb = flat(a), flat(b)
    return (matched(fa, fb) + matched(fb, fa)) / max(1, len(fa) + len(fb))


def timed_train(model_type, cfg, dev, compute_dtype=None, steps: int = 25,
                warmup: int = 5) -> dict:
    """``steps`` steps of a fresh ``model_type`` at phase 13's batch, batch
    stream and generator (``device_prefetch``), the dynamic loss-scaled
    step when ``compute_dtype`` is set; the timed steps are those after
    ``warmup``.  Returns the initial state dict, the state, one step
    ``run(weak, strong, generator)``, the losses, the skipped steps, the
    wall of the timed steps, the peak memory and the kernel launches."""
    import torch
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.step import init_loss_scale
    state = new_state(model_type, cfg, dev, compute_dtype=compute_dtype)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    scaled = compute_dtype is not None
    step = train_step(state, cfg, loss_scale='dynamic' if scaled else None)
    scale = [init_loss_scale()]

    def run(weak, strong, generator):
        if not scaled:
            return step(weak, strong, generator)
        metrics, scale[0] = step(weak, strong, generator, scale[0])
        return metrics

    generator = torch.Generator(device=dev).manual_seed(1234)
    batches = device_prefetch(train_batches(train_pools(cfg), 7, WEAK_BS,
                                            STRONG_BS), size=2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_logmel.launches = 0
    reset_conv_counts()
    losses, skipped = [], 0
    for i in range(steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        weak, strong = next(batches)
        metrics = run(weak, strong, generator)
        losses.append(metrics['loss'])
        skipped += not metrics.get('grads_finite', True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_epilogues(f'{model_type} training', state.model, 0)
    out = dict(init=init, state=state, run=run, generator=generator,
               batch=next(batches), losses=torch.stack(losses).cpu(),
               skipped=skipped, wall=wall, launches=fused_logmel.launches,
               peak=torch.cuda.max_memory_allocated(dev), scale=scale[0])
    batches.close()
    return out


def bf16_phase(card: str, dev, cfg, pcm, gpu) -> int:
    """Phase 16; returns the log-mel launches of its main-path runs."""
    import numpy as np
    import torch
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    model_type = 'Cnn_9layers_Gru_FrameAtt'
    ckpt = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
    b16 = SedInferenceEngine(load_npz(ckpt, model_type, cfg, dev,
                                      compute_dtype=torch.bfloat16),
                             cfg, dev, batch_size=32)
    fused_logmel.launches = 0
    reset_conv_counts()
    ev_b, _ = b16.predict_clips(pcm)
    launches = fused_logmel.launches
    assert launches > 0, 'the bf16 path did not launch the log-mel kernel'
    check_epilogues('[16] bf16', b16.model, launches)
    ev_f, _ = gpu.predict_clips(pcm)
    fw_b, cw_b = b16.infer_framewise(pcm)
    fw_f, cw_f = gpu.infer_framewise(pcm)
    assert fw_b.shape == fw_f.shape and np.isfinite(fw_b).all()
    fw_err = float(np.abs(fw_b - fw_f).max())
    cw_err = float(np.abs(cw_b - cw_f).max())
    share = event_match(ev_b, ev_f)
    print(f'[16] bf16 conv stack, predict_clips on {dev}: {len(pcm)} int16 '
          f'clips, {sum(map(len, ev_b))} events (float32: '
          f'{sum(map(len, ev_f))}), {share!r} matched both ways within '
          f'{BF16_EVENT_TOL_S} s (gate {BF16_EVENT_SHARE}); max |framewise '
          f'bf16 - float32| {fw_err!r} (gate {BF16_FRAMEWISE_ATOL}), '
          f'clipwise {cw_err!r}; log-mel kernel launches {launches}')
    assert fw_err < BF16_FRAMEWISE_ATOL, fw_err
    assert share >= BF16_EVENT_SHARE, share
    bench = np.concatenate([pcm] * 8)                      # 512 clips
    rates = {'bf16': [], 'f32': []}
    for tag in ('f32', 'bf16', 'bf16', 'f32'):
        rates[tag] += clips_per_s(b16 if tag == 'bf16' else gpu, bench,
                                  runs=2)[0]
    print(f'[16] predict_clips 512 int16 clips, batch 32, on {card}: bf16 '
          f'{[round(r, 1) for r in rates["bf16"]]} clips/s, float32 '
          f'{[round(r, 1) for r in rates["f32"]]} (2 runs each, in turns '
          'float32, bf16, bf16, float32)')
    by = profile_by_group(lambda: b16.predict_clips(pcm[:32]),
                          SERVE_OP_GROUPS + CAST_GROUP, '16',
                          'one bf16 predict_clips batch of 32')
    print(f'[16] bf16 serving batch: conv stack {by["conv stack"]:.0f} us, '
          f'{by["conv stack"] / by["busy"]:.4f} of the device time')

    # training at configs[4], bf16 and float32 from the same init, batches
    # and generator
    runs = {}
    for tag, dtype in (('bf16', torch.bfloat16), ('f32', None)):
        r = runs[tag] = timed_train(model_type, cfg, dev, dtype)
        launches += r['launches']
        print(f'[16] train {model_type} {tag} on {card}: weak {WEAK_BS} + '
              f'strong {STRONG_BS} clips of 10 s a step, '
              f'specaugment_timeshift_mixup; 20 timed steps (after 5) in '
              f'{r["wall"]:.3f} s: {20 / r["wall"]:.3f} steps/s, '
              f'{20 * (WEAK_BS + STRONG_BS) / r["wall"]:.1f} clips/s; peak '
              f'memory {r["peak"] / 2**30:.2f} GiB; skipped steps '
              f'{r["skipped"]}' + (f', loss scale {r["scale"].scale}'
                                   if dtype else '')
              + f'; log-mel kernel launches {r["launches"]} (25 steps)')
        assert torch.isfinite(r['losses']).all(), f'{tag}: a loss is not finite'
        assert r['launches'] == 2 * 25 and r['state'].step == 25 - r['skipped']
        if dtype is not None:
            by = profile_by_group(
                lambda: r['run'](*r['batch'], r['generator']),
                TRAIN_OP_GROUPS + CAST_GROUP, '16', 'one bf16 train step')
            conv = by['conv forward'] + by['conv backward']
            print(f'[16] bf16 train step: convolutions {conv:.0f} us, '
                  f'{conv / by["busy"]:.4f} of the device time')
    assert all(torch.equal(v, runs['f32']['init'][k])
               for k, v in runs['bf16']['init'].items())
    assert runs['bf16']['skipped'] == 0
    lb, lf = runs['bf16']['losses'].double(), runs['f32']['losses'].double()
    rel = (lb - lf).abs() / lf.abs()
    print(f'[16] train correct, bf16 against float32 from one init: losses '
          f'bf16 {lb.tolist()}, float32 {lf.tolist()}; |bf16 - float32| / '
          f'float32 per step {rel.tolist()}; max {rel.max().item()!r} (gate '
          f'{BF16_LOSS_RTOL})')
    assert rel.max().item() <= BF16_LOSS_RTOL, rel.max().item()
    return launches


def grad_diff(got: dict, want: dict) -> float:
    """The largest over the parameters of |got - want| / max |want| of the
    tensor, less a floor of 1e-6 of the model's largest gradient:
    ``att_block.att.bias`` has an exact gradient of 0 (a softmax does not
    see a shift common to its inputs), float32 noise on both sides."""
    import torch
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    return max((((got[k].to(g.device) - g).abs().max() - floor).clamp_min(0)
                / g.abs().max().clamp_min(1e-30)).item()
               for k, g in want.items())


# The data-parallel step's gradients against the exact (float64) step:
# no worse than this many times the single-process float32 step's error,
# or 1e-5 of each tensor's max |g|, whichever is larger.  At phase 13's
# batch (10 s clips) both float32 steps sit far more than 1e-5 of a
# tensor's max |g| from float64 in the first blocks, where the BatchNorm
# backward cancels over ~10^6 elements a channel (phase 17 prints both
# errors), so 1e-5 between the two float32 steps holds only at the CPU
# tests' 1 s clips.
DP_GRAD_FACTOR = 2.0


def float64_grads(model_type, cfg, dev, weak: dict, strong: dict,
                  seed: int) -> dict:
    """The gradients of one single-process step on the global batch with
    the model, the wire decode and log-mel (float64 matrix products in
    place of the kernel) in float64, the same draws: the exact step the
    float32 steps are held to."""
    from unittest import mock
    import torch
    import sed_tpu_torch.dsp.frontend as fe
    state = new_state(model_type, cfg, dev)
    state.model.double()

    def logmel64(wav, cfg):
        stft, mel = fe.frontend_matrices(cfg, wav.device)
        spec = fe.spectrogram(wav, stft.double(), cfg.hop_size,
                              center=cfg.center, pad_mode=cfg.pad_mode)
        return fe.power_to_db(spec @ mel.double(), ref=cfg.ref,
                              amin=cfg.amin)

    def to64(batch):
        out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        out['waveform'] = out['waveform'].double() / 32767.0
        return out
    with mock.patch('sed_tpu_torch.models.base.fused_logmel', logmel64), \
            mock.patch('sed_tpu_torch.ops.wire.dequant_wire',
                       lambda w, samples=None: w):
        train_step(state, cfg)(to64(weak), [to64(strong)], torch.Generator(
            device=dev).manual_seed(seed))
    return {k: p.grad.cpu() for k, p in state.model.named_parameters()}


def check_dp_grads(tag: str, got: dict, single: dict, exact: dict) -> None:
    """Print and gate a dp step's gradients against the single-process
    float32 step's and the exact step's (``DP_GRAD_FACTOR``)."""
    g_dp, g_one = grad_diff(got, exact), grad_diff(single, exact)
    gate = max(1e-5, DP_GRAD_FACTOR * g_one)
    print(f'[17] {tag}: gradients against float64 (worst tensor, of its max '
          f'|g|): dp {g_dp!r}, single process {g_one!r} (gate {gate!r}); dp '
          f'against single process {grad_diff(got, single)!r}')
    assert g_dp <= gate, (g_dp, g_one)


def _dp_rank(rank: int, n: int, store: str, model_type: str, weak: dict,
             strong: dict, seed: int) -> dict:
    """Phase 17 (c): one gloo rank on cuda:0, its share of the global
    batch through the data-parallel step from ``new_state``'s init."""
    import torch
    import torch.distributed as dist
    from sed_tpu_torch.config import AUDIO_16K
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.parallel.mesh import shard_batch
    from sed_tpu_torch.serve.engine import disable_tf32
    disable_tf32()
    dev = torch.device('cuda', 0)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=n)
    try:
        state = new_state(model_type, AUDIO_16K, dev)
        step = train_step(state, AUDIO_16K, group=dist.group.WORLD)
        w, s = shard_batch(weak, device=dev), shard_batch(strong, device=dev)
        fused_logmel.launches = 0
        reset_conv_counts()
        metrics = step(w, [s], torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        check_epilogues(f'[17] rank {rank}', state.model, 0)
        return {'launches': fused_logmel.launches,
                'rows': (len(w['waveform']), len(s['waveform'])),
                'loss': metrics['loss'].item(),
                'grads': {k: p.grad.cpu()
                          for k, p in state.model.named_parameters()},
                'state': {k: v.cpu()
                          for k, v in state.model.state_dict().items()}}
    finally:
        dist.destroy_process_group()


def parallel_phase(card: str, dev, cfg, pcm, gpu, adpcm) -> int:
    """Phase 17; returns the log-mel launches of its main-path runs (the
    ranks' of (c) included)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.parallel.distributed import spawn_ranks
    from sed_tpu_torch.parallel.dryrun import dryrun_multichip
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    model_type = 'Cnn_9layers_Gru_FrameAtt'

    # (a) two replicas on the one card
    two = SedInferenceEngine(gpu.model, cfg, devices=[dev, dev],
                             batch_size=32)
    launches = 0
    for name, wire in (('int16', pcm), ('adpcm4', adpcm)):
        fused_logmel.launches = 0
        reset_conv_counts()
        got = two.predict_clips(wire)
        launched = fused_logmel.launches
        assert launched > 0, f'the replicas did not launch the kernel ({name})'
        check_epilogues(f'[17] (a) replicas {name}', gpu.model, launched)
        launches += launched
        assert got == gpu.predict_clips(wire), \
            f'{name}: the replicated engine differs from one device'
        print(f'[17] (a) SedInferenceEngine(devices=[{dev}, {dev}]) '
              f'predict_clips of {len(wire)} {name} clips: '
              f'{sum(map(len, got[0]))} events, events and XML identical to '
              f'the single-device engine; kernel launches {launched}')
    bench = np.concatenate([pcm] * 8)
    rates = {'one': [], 'two': []}
    for tag in ('one', 'two', 'two', 'one'):
        rates[tag] += clips_per_s(two if tag == 'two' else gpu, bench,
                                  runs=2)[0]
    print(f'[17] (a) predict_clips 512 int16 clips, batch 32, on {card}: two '
          f'replicas {[round(r, 1) for r in rates["two"]]} clips/s, one '
          f'device {[round(r, 1) for r in rates["one"]]} (2 runs each, in '
          'turns)')
    del two

    # (b) a 1-rank NCCL group: the dp step (gradient and BatchNorm
    # all-reduces) against the single-process step, both against the
    # float64 step
    weak, strong = next(train_batches(train_pools(cfg), 7, WEAK_BS,
                                      STRONG_BS))
    strong = strong[0]

    def to(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    seed = 5
    exact = float64_grads(model_type, cfg, dev, weak, strong, seed)
    torch.cuda.empty_cache()
    states, grads, losses = {}, {}, {}
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', init_method=f'file://{tmp}/store',
                                rank=0, world_size=1)
        try:
            for tag in ('single', 'dp'):
                state = states[tag] = new_state(model_type, cfg, dev)
                step = train_step(state, cfg, group=dist.group.WORLD
                                  if tag == 'dp' else None)
                fused_logmel.launches = 0
                reset_conv_counts()
                losses[tag] = step(to(weak), [to(strong)], torch.Generator(
                    device=dev).manual_seed(seed))['loss'].item()
                check_epilogues(f'[17] (b) {tag}', state.model, 0)
                grads[tag] = {k: p.grad.cpu()
                              for k, p in state.model.named_parameters()}
                print(f'[17] (b) {tag} step at weak {WEAK_BS} + strong '
                      f'{STRONG_BS}: loss {losses[tag]!r}')
            launches += fused_logmel.launches
            assert fused_logmel.launches == 2
        finally:
            dist.destroy_process_group()
    check_dp_grads('(b) 1-rank NCCL', grads['dp'], grads['single'], exact)
    check_state_diff(state_diff(states['dp'], states['single']),
                     '(b) 1-rank NCCL dp step - single-process step',
                     phase=17)
    single_state = {k: v.cpu()
                    for k, v in states['single'].model.state_dict().items()}
    del states

    # (c) two gloo ranks on cuda:0, half the batch each, against the
    # single-process step on the global batch of (b)
    t0 = time.perf_counter()
    ranks = spawn_ranks(_dp_rank, 2, (model_type, weak, strong, seed),
                        timeout=300.0)
    wall = time.perf_counter() - t0
    for k, v in ranks[0]['state'].items():
        assert torch.equal(v, ranks[1]['state'][k]), f'ranks differ at {k}'
    print(f'[17] (c) 2 gloo ranks on {dev} (spawned, {wall:.1f} s): rows '
          f'{[r["rows"] for r in ranks]}, log-mel kernel launches per rank '
          f'{[r["launches"] for r in ranks]}, loss {ranks[0]["loss"]!r} '
          f'(single process on the global batch {losses["single"]!r}); the '
          'ranks bit-identical')
    assert all(r['launches'] == 2 for r in ranks)
    launches += sum(r['launches'] for r in ranks)
    check_dp_grads('(c) 2 gloo ranks', ranks[0]['grads'], grads['single'],
                   exact)
    assert abs(ranks[0]['loss'] - losses['single']) <= \
        1e-5 * abs(losses['single'])
    check_state_diff(state_dict_diff(ranks[0]['state'], single_state),
                     '(c) 2-rank gloo dp step - single-process step',
                     phase=17)
    del ranks, grads, exact

    # (d) the four-stage dry run, on the host's CPU
    print('[17] (d) CPU dry run: dryrun_multichip(4) in 4 gloo processes on '
          'the host\'s CPU (not the card)')
    t0 = time.perf_counter()
    dryrun_multichip(4)
    print(f'[17] (d) CPU dry run done in {time.perf_counter() - t0:.1f} s')
    return launches


def v6_read_bytes(payloads, samples: int) -> int:
    """The pool bytes a v6 decode of ``payloads`` must read: each clip's
    header and the data words its sub-group widths name (the payload
    without its pad to 16 bytes), and its int32 offset."""
    import numpy as np
    from sed_tpu_torch.data import audio_io
    nb = samples // audio_io.Q4_BLOCK
    hb = audio_io.v6_header_bytes(nb)
    total = 0
    for p in payloads:
        mode = np.asarray(p[2 * nb:4 * nb]).view(np.uint16).astype(np.int64)
        words = sum(int(((mode >> (2 + 3 * g)) & 7).sum()) for g in range(4))
        total += hb + 4 * words + 4
    return total


def v6_bound_ms(read_bytes: int, order) -> tuple:
    """The least time an H100 SXM could take for the whole v6 pool
    decode: the larger of its bytes (``v6_read_bytes``, read once, and
    the float32 output, 128 samples a lane, written once) over 3.35 TB/s
    and its integer operations over the INT32 pipe's ~16.7 T/s
    (``INT32_OPS_PER_S``; the conversion and the scale are counted at
    that rate too), counted per sample for each lane's order: the
    unpack's shift, mask and offset (3), the add of the residual, the int
    -> float conversion and the scale multiply (3), plus 0 / 0 / 2 / 4
    operations of the order 0 / 1 / 2 / 3 prediction.  Returns (ms,
    'bytes' or 'operations', ops ms, bytes ms)."""
    import numpy as np
    order = np.asarray(order)
    per_order = np.array([6, 6, 8, 10])
    ops = 128 * per_order[order].sum()
    bytes_ms = (read_bytes + 4 * 128 * order.size) / 3.35e12 * 1e3
    ops_ms = float(ops) / INT32_OPS_PER_S * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms > bytes_ms
                                   else 'bytes'), ops_ms, bytes_ms


RESIDENT_FORMATS = ('int16', 'mulaw', 'adpcm4', 'q4', 'q5', 'q6')


def resident_phase(card: str, dev, cfg, clips, gpu, cpu) -> tuple:
    """Phase 18; returns the log-mel launches of its main-path runs, the
    ADPCM kernel's launches on the adpcm4 files and the v6 decode
    kernel's entry of the ``kernels`` line (without its name, route,
    source and replaces)."""
    import numpy as np
    import torch
    from sed_tpu_torch.cli import predict as predict_cli
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.native import adpcm_native
    from sed_tpu_torch.ops import wire as wire_ops
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    sr = cfg.sample_rate
    n = len(clips)
    savers = {
        'int16': audio_io.save_wav, 'mulaw': audio_io.save_wav_mulaw,
        'adpcm4': audio_io.save_wav_adpcm,
        **{f'q{b}': (lambda p, x, r, b=b: audio_io.save_qn(p, x, r, b))
           for b in (4, 5, 6)},
        'v6': audio_io.save_v6}
    launches = 0

    def counted(fn, what: str):
        """``fn()`` with the log-mel and epilogue counts set to 0 just
        before and read just after; fails if the log-mel kernel was not
        launched or an epilogue of a forward was not the kernel."""
        nonlocal launches
        fused_logmel.launches = 0
        reset_conv_counts()
        out = fn()
        launched = fused_logmel.launches
        assert launched > 0, f'{what} did not launch the log-mel kernel'
        check_epilogues(f'[18] {what}', gpu.model, launched)
        launches += launched
        return out, launched

    encoder = ('native (csrc/adpcm_codec.cc, g++)'
               if adpcm_native.native_available() else 'numpy (no g++)')
    print(f'[18] ADPCM encoder: {encoder}')
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for fmt, save in savers.items():
            os.makedirs(os.path.join(tmp, fmt))
            ext = '.wav' if fmt in ('int16', 'mulaw', 'adpcm4') else f'.{fmt}'
            paths[fmt] = [os.path.join(tmp, fmt, f'c{i:02d}{ext}')
                          for i in range(n)]
            t0 = time.perf_counter()
            for p, x in zip(paths[fmt], clips):
                save(p, x, sr)
            size = sum(os.path.getsize(p) for p in paths[fmt]) / n
            print(f'[18] wrote {n} clips as {fmt} in '
                  f'{time.perf_counter() - t0:.3f} s, {size:.1f} bytes a '
                  f'file')
        names = [os.path.basename(p) for p in paths['int16']]

        # (a) the fixed-width files through wire_reader_for
        results = {}
        adpcm_launch = 0
        for fmt in RESIDENT_FORMATS:
            reader = audio_io.wire_reader_for(paths[fmt][0])
            rows = np.stack([reader(p) for p in paths[fmt]])
            wire_ops._adpcm_decode.launches = 0
            got, launched = counted(lambda: gpu.predict_files_resident(
                paths[fmt], reader, names=names), f'{fmt} files')
            if fmt == 'adpcm4':
                adpcm_launch = wire_ops._adpcm_decode.launches
                assert adpcm_launch > 0, \
                    'the adpcm4 files did not launch the ADPCM kernel'
                print(f'[18] adpcm4 files: ADPCM kernel launches '
                      f'{adpcm_launch}')
            assert got == gpu.predict_clips(rows, names), \
                f'{fmt}: predict_files_resident differs from predict_clips'
            assert [r[:8] for r in got] == list(cpu.predict_clips(
                rows[:8], names[:8])), f'{fmt}: GPU differs from the CPU'
            results[fmt] = got
            print(f'[18] {fmt} files ({rows.shape[1]} {rows.dtype} a row): '
                  f'predict_files_resident = predict_clips on the same rows,'
                  f' first 8 = the CPU engine; {sum(map(len, got[0]))} '
                  f'events, log-mel launches {launched}')
        reader = audio_io.wire_reader_for(paths['int16'][0])
        split, _ = counted(lambda: gpu.predict_files_resident(
            paths['int16'], reader, names=names, max_pass_clips=24),
            'passes of 24 clips')
        assert split == results['int16'], 'max_pass_clips=24 differs'
        print('[18] int16 in passes of 24 clips: equal to one pass')

        # (b) v6: the ragged pass, the rows entry, the pool decode
        payloads = [audio_io.read_v6(p)[0] for p in paths['v6']]
        sizes = [len(p) for p in payloads]
        q6_bytes = audio_io.qn_bytes(gpu.window_samples, 6)
        print(f'[18] v6 payloads of the {n} bench-corpus clips: mean '
              f'{float(np.mean(sizes))!r} bytes (min {min(sizes)}, max '
              f'{max(sizes)}) against q6\'s {q6_bytes}: '
              f'{float(np.mean(sizes)) / q6_bytes!r} of q6')
        v6_launch = 0
        for entry, fn in (
                ('predict_files_resident_ragged',
                 lambda: gpu.predict_files_resident_ragged(
                     paths['v6'], lambda p: audio_io.read_v6(p)[0],
                     names=names)),
                ('predict_rows_resident',
                 lambda: gpu.predict_rows_resident(payloads, names))):
            wire_ops.dequant_v6_pool.launches = 0
            got, launched = counted(fn, entry)
            assert wire_ops.dequant_v6_pool.launches > 0, \
                f'{entry} did not launch the v6 decode kernel'
            v6_launch += wire_ops.dequant_v6_pool.launches
            assert got == results['q6'], f'{entry}: v6 differs from q6'
            print(f'[18] {entry}: events and XML identical to the q6 '
                  f'files\'; log-mel launches {launched}, v6 kernel '
                  f'launches {wire_ops.dequant_v6_pool.launches}')

        # (c) the CLI
        ws = os.path.join(tmp, 'ws')
        _, launched = counted(lambda: predict_cli.main([
            'predict', '--workspace', ws, '--input_dir',
            os.path.join(tmp, 'int16'), '--audio_16k', '--checkpoint',
            os.path.join(REPO, 'tools', 'bench_checkpoint.npz'),
            '--device', 'cuda', '--batch_size', '32', '--resident']),
            'predict --resident')
        for name, xml in zip(names, results['int16'][1]):
            with open(os.path.join(ws, 'predict_results',
                                   name[:-4] + '.xml')) as f:
                assert f.read() == xml, f'CLI XML of {name} differs'
        print(f'[18] predict --resident --device cuda on the int16 '
              f'directory: {n} XML files identical to (a); log-mel '
              f'launches {launched}')

        # (d) rates over 512 clips, file reads included
        def rate(fn, runs: int = 3):
            fn()
            out = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                out.append(round(8 * n / (time.perf_counter() - t0), 1))
            return out

        pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
        bench = np.concatenate([pcm] * 8)
        modes = {f'{fmt} files': (lambda fmt=fmt: gpu.predict_files_resident(
                     paths[fmt] * 8, audio_io.wire_reader_for(
                         paths[fmt][0])))
                 for fmt in ('int16', 'adpcm4', 'q6')}
        modes['v6 rows'] = lambda: gpu.predict_rows_resident(payloads * 8)
        modes['predict_clips int16'] = lambda: gpu.predict_clips(bench)
        rates = {name: [] for name in modes}
        for r in range(2):
            for name in (modes if r % 2 == 0 else reversed(list(modes))):
                rates[name] += rate(modes[name], runs=2)
        print(f'[18] clips/s over 512 clips, batch 32, on {card} (4 runs '
              f'each, in turns; files read on the host inside the call): '
              + '; '.join(f'{k} {v}' for k, v in rates.items()))

    # the pool decode of one 32-clip batch: kernel against plain and numpy
    samples = gpu.window_samples
    rows32 = payloads[:32]
    pool = np.concatenate(rows32 + [np.zeros(8192, np.uint8)]).view(np.int32)
    offs = (np.concatenate([[0], np.cumsum(sizes[:32])]) // 4).astype(
        np.int32)                          # 32 clips and a padding row
    pool_d = torch.from_numpy(pool).to(dev)
    offs_d = torch.from_numpy(offs).to(dev)
    dec = wire_ops.dequant_v6_pool(pool_d, offs_d, samples)
    plain = wire_ops._v6_decode_plain(pool_d, offs_d, samples)
    err = (dec - plain).abs().max().item()
    assert torch.equal(dec.view(torch.int32), plain.view(torch.int32)), \
        'the v6 kernel differs from its plain version'
    dec = dec.cpu().numpy()
    for i, row in enumerate(rows32):
        want = audio_io.v6_decode_np(row, samples)
        assert np.array_equal(dec[i].view(np.int32), want.view(np.int32)), \
            f'v6 clip {i} differs from v6_decode_np'
        err = max(err, float(np.abs(dec[i] - want).max()))
    assert not dec[-1].view(np.int32).any(), 'the padding row is not silent'
    # a seeded random-word pool: every order and width (7 included), NaN
    # and inf scales, order 3 wrapping, offsets into the tail and past P
    rng = np.random.RandomState(18)
    words = rng.randint(-2 ** 31, 2 ** 31, 1 << 20, dtype=np.int64)
    roffs = np.concatenate([rng.randint(0, 1 << 20, 27), [
        (1 << 20) - 3, (1 << 20) - 1, (1 << 20) + 5000, -11, 2 ** 31 - 7]])
    words_d = torch.from_numpy(words.astype(np.int32)).to(dev)
    roffs_d = torch.from_numpy(roffs.astype(np.int32)).to(dev)
    got = wire_ops.dequant_v6_pool(words_d, roffs_d, samples)
    want = wire_ops._v6_decode_plain(words_d, roffs_d, samples)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        'the v6 kernel differs from its plain version on random words'
    print(f'[18] v6 decode kernel bit-exact to its plain version on the '
          f'card: the 32 bench clips and a padding row (and to '
          f'v6_decode_np, the padding row silent), and a random-word pool of '
          f'{len(words)} words at {len(roffs)} offsets '
          f'({int(torch.isnan(want).sum())} NaN samples)')

    def decode():
        return wire_ops.dequant_v6_pool(pool_d, offs_d[:32], samples)

    ms = queued_ms(decode)
    plain_ms = cuda_ms(lambda: wire_ops._v6_decode_plain(
        pool_d, offs_d[:32], samples), runs=5)
    order = wire_ops.v6_fields(pool_d, offs_d[:32], samples)[1].cpu().numpy()
    bound = v6_bound_ms(v6_read_bytes(rows32, samples), order)
    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        decode()
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    print(f'[18] v6 pool decode of 32 x {samples} ({len(order)} lanes) on '
          f'{card}: kernel {ms!r} ms (20 launches queued behind a spin '
          f'kernel, CUDA events; one call alone between events '
          f'{cuda_ms(decode)!r} ms), the wrapper\'s host time {host_us!r} '
          f'us a call (100 calls, host clock); plain {plain_ms!r} ms (CUDA '
          f'events, median of 5); bound {bound[0]!r} ms by {bound[1]} (bytes '
          f'{bound[3]!r} ms, operations {bound[2]!r} ms); kernel at '
          f'{bound[0] / ms!r} of it')
    n = graph_launches(decode)
    print(f'[18] one v6 pool decode of 32 clips: {n} device launches (nodes '
          f'of a CUDA graph capturing it)')
    assert 1 <= n <= 2, f'one v6 pool decode took {n} launches'
    return launches, adpcm_launch, {
        'launches': v6_launch, 'max_abs_err': err, 'ms': ms,
        'plain_ms': plain_ms, 'bound_ms': bound[0], 'bound_by': bound[1],
        'library_ms': None}


# Phase 19's gate, fixed before the first run on the card: on the test
# split, the best checkpoint of an 801-iteration run of the bench model's
# training against ``tools/bench_checkpoint.npz`` (which ``sed_tpu``
# trained with the same flags on the same corpus from the same
# initialisation) in the same run
LEARN_ER_MARGIN = 0.10           # ER <= bench ER + 0.10
LEARN_F1_MARGIN = 0.07           # F1 >= bench F1 - 0.07
LEARN_MAP_MARGIN = 0.05          # framewise mAP >= bench's - 0.05
EXPORT_TOL = 0.01                # exported (float16) ER, F1 against best
WIRE_ITERATIONS = 20


def learning_phase(card: str, dev, cfg, pcm) -> tuple:
    """Phase 19; returns the log-mel and the ADPCM kernel's launches of
    its training, evaluation and serving runs."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    import torch_make_bench_checkpoint as make_ckpt
    import torch_synthetic_learning_check as learning
    from sed_tpu_torch.cli import main_strong
    from sed_tpu_torch.compat.from_flax import load_checkpoint, load_npz
    from sed_tpu_torch.data.dataset import DataLoader, TestSampler
    from sed_tpu_torch.eval.evaluator import Evaluator
    from sed_tpu_torch.ops import wire as wire_ops
    from sed_tpu_torch.ops.conv_epilogue import conv_epilogue
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    gru = 'Cnn_9layers_Gru_FrameAtt'
    t19 = time.perf_counter()
    launches = {'logmel': 0, 'adpcm': 0}

    def counted(fn, *args, **kwargs):
        """``fn``'s result and its launches of the log-mel, ADPCM and
        epilogue kernels; the first two added up."""
        fused_logmel.launches = 0
        wire_ops._adpcm_decode.launches = 0
        reset_conv_counts()
        out = fn(*args, **kwargs)
        n = (fused_logmel.launches, wire_ops._adpcm_decode.launches,
             conv_epilogue.launches)
        launches['logmel'] += n[0]
        launches['adpcm'] += n[1]
        return out, n

    # -- (a) the corpus in memory --------------------------------------------
    corpus = learning.build_corpus(make_ckpt.SIZES)
    print(f'[19] (a) corpus of {make_ckpt.SIZES} clips of 10 s (the 96/96/'
          f'24/24 of tools/make_bench_checkpoint.py) built in memory in '
          f'{corpus.seconds:.2f} s')
    tmp = tempfile.TemporaryDirectory()
    learning.write_references(corpus, tmp.name)
    test_csv = os.path.join(tmp.name, 'metadata',
                            'groundtruth_strong_label_testing_set.csv')

    def evaluate(model, device, tag):
        """The model's test-split summary through the Evaluator."""
        loader = DataLoader(learning.MemoryDataset(corpus.splits),
                            TestSampler('testing', 4, audios_num=len(
                                corpus.splits['testing']['audio_name'])))
        stats, _ = Evaluator(model, device).evaluate(
            loader, test_csv, os.path.join(tmp.name, f'{tag}.tsv'),
            cfg.frames_per_second)
        return learning.summarize(stats)

    def fmt(m):
        return (f'ER {m["er"]!r} F1 {m["f1"]!r} framewise mAP '
                f'{m["framewise_map"]!r} clipwise mAP {m["clipwise_map"]!r}')

    # -- (c) sed_tpu's trained checkpoint on the test split ------------------
    ckpt = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
    bench_model = load_npz(ckpt, gru, cfg, dev)
    bench, n = counted(evaluate, bench_model, dev, 'bench_gpu')
    check_epilogues('[19] (c) Evaluator', bench_model, n[0])
    bench_cpu = evaluate(load_npz(ckpt, gru, cfg, 'cpu'), 'cpu', 'bench_cpu')
    print(f'[19] (c) tools/bench_checkpoint.npz on the '
          f'{len(corpus.splits["testing"]["audio_name"])} test clips, '
          f'Evaluator on {dev} (log-mel launches {n[0]}): {fmt(bench)}; on '
          f'the CPU: {fmt(bench_cpu)}')
    assert n[0] > 0, 'the Evaluator did not launch the log-mel kernel'
    assert (bench['er'], bench['f1']) == (bench_cpu['er'], bench_cpu['f1']), \
        'ER / F1 of the bench checkpoint differ between the card and the CPU'

    def train(tag, extra):
        """A run of the CLI's loop on the corpus, its report printed."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        run, n = counted(learning.train, corpus, extra,
                         os.path.join(tmp.name, re.sub(r'\W+', '_', tag)),
                         verbose=False)
        train_s = run.wall_s - run.eval_s
        evals = len(run.evaluations)
        weak_bs, strong_bs = main_strong.batch_sizes(run.args)
        flags = ' '.join(f if not f.endswith('.npz') else
                         os.path.basename(f) for f in extra)
        print(f'[19] {tag}: {run.steps} iterations on {card} through '
              f'main_strong.train_loop ({flags}): '
              f'{run.steps / train_s:.3f} steps/s, '
              f'{run.steps * (weak_bs + strong_bs) / train_s:.1f} train '
              f'clips/s ({weak_bs} weak + {strong_bs} strong clips of 10 s '
              f'a step), training {train_s:.2f} s, '
              f'{evals} evaluations {run.eval_s:.2f} s, wall '
              f'{run.wall_s:.2f} s, peak memory '
              f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; '
              f'log-mel launches {n[0]}, ADPCM launches {n[1]}')
        at = sorted({*range(0, run.steps, 100), run.steps - 1})
        print(f'[19] {tag}: loss at ' + ', '.join(
            f'{i}: {run.losses[i]:.4f}' for i in at))
        for e in run.evaluations:
            print(f'[19] {tag}: iteration {e["iteration"]}: valid '
                  f'{fmt(e["valid"])}; test {fmt(e["test"])}')
        assert np.isfinite(run.losses).all(), f'{tag}: a loss is not finite'
        # an evaluation forwards the validation and the test split
        batches = sum(-(-len(corpus.splits[k]['audio_name'])
                        // run.args.batch_size)
                      for k in ('strong_validation', 'testing'))
        assert n[0] >= 2 * run.steps + evals * batches, \
            f'{tag}: {n[0]} log-mel launches for {run.steps} steps'
        # the evaluations' forwards of the 4-block stack, 8 each; the
        # training steps none
        assert n[2] % 8 == 0 and n[2] >= 8 * evals * batches, \
            f'{tag}: {n[2]} conv epilogue launches in {evals} evaluations'
        epilogue_launches.append(n[2])
        return run, n

    def falls(tag, run):
        """The mean loss of the last 100 iterations below the first
        100's."""
        k = min(100, run.steps // 2)
        first = float(run.losses[:k].mean())
        last = float(run.losses[-k:].mean())
        print(f'[19] {tag}: mean loss of the first {k} iterations '
              f'{first!r}, of the last {k} {last!r}; best iteration '
              f'{run.best_iteration}, test {fmt(run.best("test"))}')
        assert last < first, f'{tag}: the loss did not fall'

    def gate(tag, run):
        best = run.best('test')
        print(f'[19] (d) {tag}: best iteration {run.best_iteration}, test '
              f'{fmt(best)}; bench checkpoint {fmt(bench)}; gate ER <= '
              f'{bench["er"] + LEARN_ER_MARGIN:.4f}, F1 >= '
              f'{bench["f1"] - LEARN_F1_MARGIN:.4f}, framewise mAP >= '
              f'{bench["framewise_map"] - LEARN_MAP_MARGIN:.4f}')
        assert best['er'] <= bench['er'] + LEARN_ER_MARGIN, f'{tag}: ER'
        assert best['f1'] >= bench['f1'] - LEARN_F1_MARGIN, f'{tag}: F1'
        assert best['framewise_map'] >= \
            bench['framewise_map'] - LEARN_MAP_MARGIN, f'{tag}: mAP'

    # -- (b) the bench model in fp32 from sed_tpu's initialisation, (d) ----
    t0 = time.perf_counter()
    bench_flags = make_ckpt.train_flags(tmp.name)
    print(f'[19] (b) sed_tpu\'s PRNGKey(0) initialisation of {gru} drawn in '
          f'numpy (compat/flax_init.py) in {time.perf_counter() - t0:.2f} s')
    fp32, _ = train('(b) GRU fp32', bench_flags)
    gate('GRU fp32', fp32)

    # -- (h) its best checkpoint exported, served on the card and the CPU ---
    out = make_ckpt.export(fp32, os.path.join(tmp.name, 'gru.npz'))
    gpu = SedInferenceEngine(load_npz(out, gru, cfg, dev), cfg, dev,
                             batch_size=32)
    cpu = SedInferenceEngine(load_npz(out, gru, cfg, 'cpu'), cfg, 'cpu',
                             batch_size=32)
    (ev_gpu, xml_gpu), n = counted(gpu.predict_clips, pcm)
    check_epilogues('[19] (h) predict_clips', gpu.model, n[0])
    ev_cpu, xml_cpu = cpu.predict_clips(pcm)
    assert n[0] > 0, 'predict_clips did not launch the log-mel kernel'
    assert ev_gpu == ev_cpu and xml_gpu == xml_cpu, \
        'the exported checkpoint serves differently on the card and the CPU'
    exported, n = counted(evaluate, gpu.model, dev, 'exported')
    check_epilogues('[19] (h) Evaluator', gpu.model, n[0])
    best = fp32.best('test')
    print(f'[19] (h) best checkpoint exported by save_variables_npz '
          f'({os.path.getsize(out) / 1e6:.2f} MB): predict_clips of '
          f'{len(pcm)} clips on {dev}, {sum(map(len, ev_gpu))} events, '
          f'events and XML identical to the CPU; test {fmt(exported)} '
          f'against the in-memory best {fmt(best)}')
    assert abs(exported['er'] - best['er']) <= EXPORT_TOL and \
        abs(exported['f1'] - best['f1']) <= EXPORT_TOL, \
        'the exported checkpoint scores apart from the in-memory best'
    del gpu, cpu

    # -- (e) bf16 with the dynamic loss scale, under the same gate -----------
    bf16, _ = train('(e) GRU bf16', [*bench_flags, '--compute_dtype', 'bf16'])
    print(f'[19] (e) skipped steps {bf16.grads_finite.count(False)}, final '
          f'loss scale {bf16.loss_scales[-1]!r}')
    gate('GRU bf16', bf16)

    # -- (b') the GRU from the port's own fresh draw: finite, falling -------
    steps = ['--stop_iteration', str(make_ckpt.STOP_ITERATION)]
    fresh, _ = train("(b') GRU fp32, fresh init", steps)
    falls("(b') GRU fp32, fresh init", fresh)

    # -- (f) the Conformer: finite, falling losses; served trained ----------
    conformer = 'Cnn_9layers_Conformer_FrameAtt'
    conf, _ = train('(f) Conformer', [*steps, '--model_type', conformer])
    falls('(f) Conformer', conf)
    engine = SedInferenceEngine(load_checkpoint(
        conf.best_checkpoint, conformer, cfg, dev), cfg, dev, batch_size=32)
    (ev, _), n = counted(engine.predict_clips, pcm)
    assert n[0] > 0, 'predict_clips did not launch the log-mel kernel'
    check_epilogues('[19] (f) Conformer predict_clips', engine.model, n[0])
    rates, _ = clips_per_s(engine, np.concatenate([pcm] * 8))
    print(f'[19] (f) trained Conformer predict_clips on {card}: '
          f'{sum(map(len, ev)) / len(pcm):.3f} events a clip on the '
          f'{len(pcm)} clips, {[round(r, 1) for r in rates]} clips/s over '
          f'{8 * len(pcm)} clips (3 runs)')
    del engine

    # -- (g) the GRU on the adpcm4 wire: the ADPCM kernel on the path --------
    _, n = train('(g) GRU adpcm4', ['--stop_iteration', str(WIRE_ITERATIONS),
                                    '--train_wire', 'adpcm4'])
    assert n[1] > 0, 'the adpcm4 wire did not launch the ADPCM kernel'
    tmp.cleanup()
    print(f'[19] learning phase: log-mel launches {launches["logmel"]}, '
          f'ADPCM launches {launches["adpcm"]}; '
          f'{time.perf_counter() - t19:.1f} s')
    return launches['logmel'], launches['adpcm']


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA GPU')
    sys.path[:0] = [REPO]
    import numpy as np
    from sed_tpu_torch import _build, config
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.dsp.frontend import logmel_plain
    from sed_tpu_torch.ops.conv_epilogue import conv_epilogue
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import (SedInferenceEngine, disable_tf32,
                                            tf32_flags, window_starts)

    # -- 1. card and numerics -------------------------------------------
    card = card_line()
    print(f'[1] card: {card}')
    print(f'[1] python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}'
          f' count {torch.cuda.device_count()}')
    disable_tf32()
    print(f'[1] tf32 flags: {tf32_flags()}')
    assert not any(tf32_flags().values())
    dev = torch.device('cuda', 0)

    # -- 2. kernel builds, one nvcc a source, all started together --------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.load, KERNELS))
    print(f'[2] built {len(libs)} kernel libraries in parallel in '
          f'{time.perf_counter() - t0:.2f} s')
    for lib in libs:
        print(f'[2] {os.path.relpath(lib.path, REPO)} from '
              f'sed_tpu_torch/csrc/{lib.name}.cu with nvcc '
              f'{" ".join(_build.NVCC_FLAGS)} (nvcc {lib.build_seconds:.2f} '
              's)')
        for line in lib.build_log.splitlines():
            print(f'[2]   {line}')
        regs = [int(r) for r in re.findall(r'Used (\d+) registers',
                                            lib.build_log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r'(\d+) bytes spill stores, (\d+) bytes spill loads',
            lib.build_log)]
        smem = [int(b) for b in re.findall(r'(\d+) bytes smem',
                                           lib.build_log)]
        print(f'[2] ptxas {lib.name}: registers {regs}, shared memory '
              f'bytes {smem}, spill bytes {spills}')
        assert regs and spills and not any(spills), \
            f'ptxas spilled registers in {lib.name}'

    if '--gamma-only' in sys.argv[1:]:
        t15 = time.perf_counter()
        gamma_phase(card, dev)
        print(f'[15] gamma phase done in {time.perf_counter() - t15:.1f} '
              's; phases 3-14 were not run: no result')
        return

    only = {'--bf16-only': 16, '--parallel-only': 17}
    if only.keys() & set(sys.argv[1:]):
        cfg = config.AUDIO_16K
        clips = make_clips(64, cfg.sample_rate, seconds=5, seed=0)
        pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
        gpu = SedInferenceEngine(load_npz(
            os.path.join(REPO, 'tools', 'bench_checkpoint.npz'),
            'Cnn_9layers_Gru_FrameAtt', cfg, dev), cfg, dev, batch_size=32)
        for flag, phase in only.items():
            if flag in sys.argv[1:]:
                t0 = time.perf_counter()
                if phase == 16:
                    bf16_phase(card, dev, cfg, pcm, gpu)
                else:
                    parallel_phase(card, dev, cfg, pcm, gpu,
                                   audio_io.adpcm_encode_np(clips))
                print(f'[{phase}] phase done in '
                      f'{time.perf_counter() - t0:.1f} s')
        print('phases 3-15 were not run: no result')
        return

    if '--adpcm-only' in sys.argv[1:]:
        signals = make_clips(64, config.AUDIO_16K.sample_rate, seconds=5,
                             seed=0)
        sq = np.where((np.arange(signals.shape[1]) // 37) % 2 == 0, 1.0, -1.0)
        signals = np.concatenate([signals, sq[None], np.zeros_like(
            signals[:1])]).astype(np.float32)
        wires = {'adpcm4': audio_io.adpcm_encode_np(signals),
                 **{f'adpcm{n}': audio_io.adpcm_n_encode_np(signals, n)
                    for n in (3, 2)}}
        adpcm_kernel_checks(card, dev, signals, wires)
        print('[10] ADPCM kernel checks done; phases 3-18 were not run: '
              'no result')
        return

    if '--epilogue-only' in sys.argv[1:]:
        epilogue_checks(card, dev)
        print('[6] conv epilogue checks done; phases 3-19 were not run: no '
              'result')
        return

    if '--conv-only' in sys.argv[1:]:
        conv_checks(card, dev)
        print('[6] conv3x3 checks done; phases 3-19 were not run: no '
              'result')
        return

    if '--resident-only' in sys.argv[1:]:
        cfg = config.AUDIO_16K
        ckpt = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
        model_type = 'Cnn_9layers_Gru_FrameAtt'
        gpu = SedInferenceEngine(load_npz(ckpt, model_type, cfg, dev), cfg,
                                 dev, batch_size=32)
        cpu = SedInferenceEngine(load_npz(ckpt, model_type, cfg, 'cpu'), cfg,
                                 'cpu', batch_size=32)
        t18 = time.perf_counter()
        resident_phase(card, dev, cfg, make_clips(64, cfg.sample_rate,
                                                  seconds=5, seed=0),
                       gpu, cpu)
        print(f'[18] resident phase done in {time.perf_counter() - t18:.1f} '
              's; phases 3-17 were not run: no result')
        return

    if '--learning-only' in sys.argv[1:]:
        cfg = config.AUDIO_16K
        pcm = (np.clip(make_clips(64, cfg.sample_rate, seconds=5, seed=0),
                       -1, 1) * 32767).astype(np.int16)
        learning_phase(card, dev, cfg, pcm)
        print('[19] phases 3-18 were not run: no result')
        return

    if '--families-only' in sys.argv[1:]:
        cfg = config.AUDIO_16K
        pcm = (np.clip(make_clips(64, cfg.sample_rate, seconds=5, seed=0),
                       -1, 1) * 32767).astype(np.int16)
        t14 = time.perf_counter()
        families_phase(card, dev, cfg, pcm)
        print(f'[14] families phase done in {time.perf_counter() - t14:.1f} '
              's; phases 3-13 were not run: no result')
        return

    # -- 3. kernel vs plain ----------------------------------------------
    max_err = 0.0
    cfgs = (config.AUDIO_8K, config.AUDIO_16K, config.AUDIO_32K)
    nyquist = dataclasses.replace(config.AUDIO_16K, fmax=9600)
    for i, cfg in enumerate(cfgs + (nyquist,)):
        wav = torch.from_numpy(kernel_inputs(cfg, seed=10 + i)).to(dev)
        got = fused_logmel(wav, cfg)
        want = logmel_plain(wav, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f'[3] {cfg.name} fmax {cfg.fmax}: {tuple(got.shape)} frames % '
              f'64 = {got.shape[1] % 64}, max |kernel - plain| per clip '
              f'(4 corpus, 1e-4, half silent, full scale) = '
              f'{(got - want).abs().amax(dim=(1, 2)).tolist()} dB, '
              f'min {want.min().item():.2f} dB')
        torch.testing.assert_close(got, want, **TOL)

    # -- 4. main path: predict_clips, GPU vs CPU ---------------------------
    cfg = config.AUDIO_16K
    ckpt = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
    model_type = 'Cnn_9layers_Gru_FrameAtt'
    gpu = SedInferenceEngine(load_npz(ckpt, model_type, cfg, dev), cfg, dev,
                             batch_size=32)
    cpu = SedInferenceEngine(load_npz(ckpt, model_type, cfg, 'cpu'), cfg,
                             'cpu', batch_size=32)
    clips = make_clips(64, cfg.sample_rate, seconds=5, seed=0)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)

    fused_logmel.launches = 0
    reset_conv_counts()
    ev_gpu, xml_gpu = gpu.predict_clips(pcm)
    launches = fused_logmel.launches
    epilogues = conv_epilogue.launches
    ev_pcm = ev_gpu
    print(f'[4] predict_clips on {dev}: {len(pcm)} clips, '
          f'{sum(map(len, ev_gpu))} events, log-mel kernel launches '
          f'{launches}, conv epilogue launches {epilogues}')
    assert launches > 0, 'the main path did not launch the log-mel kernel'
    check_epilogues('[4] predict_clips', gpu.model, launches)
    ev_cpu, xml_cpu = cpu.predict_clips(pcm)
    assert ev_gpu == ev_cpu, 'events differ between GPU and CPU'
    assert xml_gpu == xml_cpu, 'XML differs between GPU and CPU'
    fw_gpu, cw_gpu = gpu.infer_framewise(pcm)
    fw_cpu, cw_cpu = cpu.infer_framewise(pcm)
    assert fw_gpu.shape == (64, 500, 25) and np.isfinite(fw_gpu).all()
    fw_err = float(np.abs(fw_gpu - fw_cpu).max())
    cw_err = float(np.abs(cw_gpu - cw_cpu).max())
    print(f'[4] events and XML identical to the CPU engine; max |framewise '
          f'gpu - cpu| = {fw_err!r}, clipwise {cw_err!r}')
    assert fw_err <= FRAMEWISE_ATOL and cw_err <= FRAMEWISE_ATOL

    # -- 5. predict_file with overlapped windows ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'long.wav')
        audio_io.save_wav(path, make_clips(1, cfg.sample_rate, seconds=12,
                                           seed=3)[0], cfg.sample_rate)
        file_gpu = gpu.predict_file(path)
        file_cpu = cpu.predict_file(path)
    assert file_gpu == file_cpu, 'predict_file differs between GPU and CPU'
    print(f'[5] predict_file (12 s, overlapped windows): '
          f'{len(file_gpu[0])} events, events and XML identical to the CPU')

    # -- 6. times ------------------------------------------------------------
    for rate in cfgs:
        for batch in (1, 32):
            wav = torch.from_numpy(make_clips(batch, rate.sample_rate,
                                              seconds=5, seed=7)).to(dev)
            times, err, frames = time_kernel(fused_logmel, logmel_plain, wav,
                                             rate)
            max_err = max(max_err, err)
            best = min(times['kernel'])
            gflop = needed_gflop(rate, batch * frames)
            tensor = 2 * batch * frames * rate.window_size ** 2
            print(f'[6] log-mel {rate.name} {batch} x {wav.shape[1]} on '
                  f'{card}: kernel {times["kernel"]} ms, plain '
                  f'{times["plain"]} ms (median of 20 each, in turns); '
                  f'kernel {gflop / best:.3f} TFLOP/s of needed work '
                  f'({gflop:.4f} GFLOP as an FFT), dense fp64 DFT '
                  f'{tensor / best / 1e9:.1f} TFLOP/s on the tensor cores; '
                  f'max |kernel - plain| {err!r} dB')
            if rate is cfg and batch == 32:     # the main path's batch
                kernel_ms, plain_ms = best, min(times['plain'])
                bound = bound_ms(rate, tuple(wav.shape), frames)
                print(f'[6] log-mel bound at {batch} x {wav.shape[1]}: '
                      f'{bound[0]:.5f} ms by {bound[1]} (operations '
                      f'{bound[2]:.5f} ms at 67 TFLOP/s, bytes '
                      f'{bound[3]:.5f} ms at 3.35 TB/s); kernel at '
                      f'{bound[0] / best:.4f} of it')

    bench = np.concatenate([pcm] * 8)                      # 512 clips
    rates, n_events = clips_per_s(gpu, bench)
    print(f'[6] predict_clips 512 int16 clips, batch 32, on {card}: '
          f'{[round(r, 1) for r in rates]} clips/s (3 runs), '
          f'{n_events} events')
    profile_batch(gpu, pcm[:32], '6')
    epilogue = epilogue_checks(card, dev)
    convs = conv_checks(card, dev)

    # -- 7. the Transformer on the card ------------------------------------
    from sed_tpu_torch.compat.bench_weights import transformer_variables
    from sed_tpu_torch.compat.from_flax import load_variables
    from sed_tpu_torch.models.registry import get_model
    tvars = transformer_variables(seed=0)

    def transformer(device):
        model = get_model('Cnn_9layers_Transformer_FrameAtt', cfg)
        return load_variables(model, tvars).to(device)

    tgpu = SedInferenceEngine(transformer(dev), cfg, dev, batch_size=32)
    tcpu = SedInferenceEngine(transformer('cpu'), cfg, 'cpu', batch_size=32)
    fused_logmel.launches = 0
    reset_conv_counts()
    ev_gpu, xml_gpu = tgpu.predict_clips(pcm)
    t_launches = fused_logmel.launches
    assert t_launches > 0, 'the Transformer path did not launch the kernel'
    check_epilogues('[7] Transformer', tgpu.model, t_launches)
    ev_cpu, xml_cpu = tcpu.predict_clips(pcm)
    assert ev_gpu == ev_cpu, 'Transformer events differ between GPU and CPU'
    assert xml_gpu == xml_cpu, 'Transformer XML differs between GPU and CPU'
    fw_gpu, cw_gpu = tgpu.infer_framewise(pcm)
    fw_cpu, cw_cpu = tcpu.infer_framewise(pcm)
    assert fw_gpu.shape == (64, 496, 25) and np.isfinite(fw_gpu).all()
    fw_err = float(np.abs(fw_gpu - fw_cpu).max())
    cw_err = float(np.abs(cw_gpu - cw_cpu).max())
    print(f'[7] Transformer predict_clips on {dev}: {len(pcm)} clips, '
          f'{sum(map(len, ev_gpu))} events, log-mel kernel launches '
          f'{t_launches}; events and XML identical to the CPU engine; max '
          f'|framewise gpu - cpu| = {fw_err!r}, clipwise {cw_err!r}')
    assert fw_err <= FRAMEWISE_ATOL and cw_err <= FRAMEWISE_ATOL
    rates, n_events = clips_per_s(tgpu, bench)
    print(f'[7] Transformer predict_clips 512 int16 clips, batch 32, on '
          f'{card}: {[round(r, 1) for r in rates]} clips/s (3 runs), '
          f'{n_events} events')
    profile_batch(tgpu, pcm[:32], '7')

    # -- 8. on-device windowed merging, GPU vs CPU ---------------------------
    from sed_tpu_torch.eval import segment_metrics
    from sed_tpu_torch.post import events as post_events
    from sed_tpu_torch.cli.main_strong import PARAM_COMBINATIONS
    clips10, truth = make_clips(32, cfg.sample_rate, seconds=10, seed=21,
                                return_events=True)
    names = [f'clip{i}_0.wav' for i in range(len(clips10))]
    w_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ref_csv = os.path.join(tmp, 'reference.csv')
        with open(ref_csv, 'w') as f:
            for name, evs in zip(names, truth):
                for e in evs:
                    f.write(f'{name},{e["onset"]},{e["offset"]},'
                            f'{e["event_label"]}\n')

        def er_f1(per_clip, tag):
            sub = os.path.join(tmp, f'{tag}.tsv')
            post_events.write_submission(
                [e for evs in per_clip for e in evs], sub)
            overall = segment_metrics.official_evaluate(ref_csv,
                                                        sub)['overall']
            return (overall['error_rate']['error_rate'],
                    overall['f_measure']['f_measure'])

        for step, window in PARAM_COMBINATIONS:
            kw = dict(sample_duration=window, overlap=True,
                      overlap_value=step, batch_size=32)
            wgpu = SedInferenceEngine(gpu.model, cfg, dev, **kw)
            wcpu = SedInferenceEngine(cpu.model, cfg, 'cpu', **kw)
            fused_logmel.launches = 0
            reset_conv_counts()
            ev_gpu = wgpu.predict_clips_windowed(clips10, names, 10.0, step)
            launched = fused_logmel.launches
            assert launched > 0, 'the windowed path did not launch the kernel'
            check_epilogues(f'[8] windowed {step, window}', wgpu.model,
                            launched)
            w_launches += launched
            ev_cpu = wcpu.predict_clips_windowed(clips10, names, 10.0, step)
            assert ev_gpu == ev_cpu, f'windowed events differ at {step, window}'
            scores = er_f1(ev_gpu, 'gpu')
            assert scores == er_f1(ev_cpu, 'cpu')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wgpu.predict_clips_windowed(clips10, names, 10.0, step)
            rate = len(clips10) / (time.perf_counter() - t0)
            print(f'[8] windowed [{step}, {window}] on {card}: '
                  f'{len(window_starts(10.0, window, True, step))} windows a '
                  f'clip, {sum(map(len, ev_gpu))} events identical to the '
                  f'CPU, kernel launches {launched}; segment ER {scores[0]!r} '
                  f'F1 {scores[1]!r} (GPU = CPU); {rate:.1f} clips/s '
                  f'(second run)')

    for seconds, batch in ((6, 27), (7, 28), (10, 32)):
        wav = torch.from_numpy(np.ascontiguousarray(
            clips10[:batch, :seconds * cfg.sample_rate])).to(dev)
        times, err, frames = time_kernel(fused_logmel, logmel_plain, wav, cfg)
        max_err = max(max_err, err)
        print(f'[8] log-mel {cfg.name} {batch} x {seconds} s ({frames} '
              f'frames) on {card}: kernel {times["kernel"]} ms, plain '
              f'{times["plain"]} ms (median of 20 each, in turns); max '
              f'|kernel - plain| {err!r} dB')

    # -- 9. the Evaluator forward, GPU vs CPU --------------------------------
    from sed_tpu_torch.eval.evaluator import Evaluator
    loader = [{'audio_name': np.array(names[i:i + 12]),
               'waveform': clips10[i:i + 12]}
              for i in range(0, len(clips10), 12)]   # 12, 12, 8
    fused_logmel.launches = 0
    reset_conv_counts()
    out_gpu = Evaluator(gpu.model, dev).forward(loader)
    e_launches = fused_logmel.launches
    assert e_launches > 0, 'the evaluator did not launch the kernel'
    check_epilogues('[9] Evaluator', gpu.model, e_launches)
    out_cpu = Evaluator(cpu.model, 'cpu').forward(loader)
    assert out_gpu['framewise_output'].shape == (32, 1000, 25)
    assert list(out_gpu['audio_name']) == names
    e_err = float(np.abs(out_gpu['framewise_output']
                         - out_cpu['framewise_output']).max())
    c_err = float(np.abs(out_gpu['clipwise_output']
                         - out_cpu['clipwise_output']).max())
    print(f'[9] Evaluator forward on {dev}: 32 clips of 10 s in batches of '
          f'12/12/8, kernel launches {e_launches}; max |framewise gpu - '
          f'cpu| = {e_err!r}, clipwise {c_err!r}')
    assert e_err <= FRAMEWISE_ATOL and c_err <= FRAMEWISE_ATOL

    # -- 10. the uint8 wires on the card ---------------------------------
    from sed_tpu_torch.ops import wire as wire_ops
    sq = np.where((np.arange(clips.shape[1]) // 37) % 2 == 0, 1.0, -1.0)
    signals = np.concatenate([clips, sq[None], np.zeros_like(clips[:1])]
                             ).astype(np.float32)
    codecs = {
        **{f'q{n}': (lambda x, n=n: audio_io.qn_encode(x, n),
                     lambda b, n=n: audio_io.qn_decode_np(b, 80000, n))
           for n in audio_io.QN_BITS},
        'mulaw': (audio_io.mulaw_encode, audio_io.mulaw_decode),
        'adpcm4': (audio_io.adpcm_encode_np,
                   lambda b: audio_io.adpcm_decode_np(b, 80000)),
        **{f'adpcm{n}': (lambda x, n=n: audio_io.adpcm_n_encode_np(x, n),
                         lambda b, n=n: audio_io.adpcm_n_decode_np(
                             b, 80000, n))
           for n in (3, 2)}}
    wires = {}
    for name, (encode, decode_np) in codecs.items():
        buf = encode(signals)
        wires[name] = buf
        got = wire_ops.dequant_wire(torch.from_numpy(buf).to(dev), 80000)
        got = got.cpu().numpy()
        assert np.array_equal(got.view(np.int32),
                              decode_np(buf).view(np.int32)), \
            f'{name}: GPU decode differs from the numpy decoder'
        batch = torch.from_numpy(buf[:32]).to(dev)
        ms = cuda_ms(lambda: wire_ops.dequant_wire(batch, 80000))
        print(f'[10] {name}: {buf.shape[1]} bytes a clip, GPU decode of '
              f'{len(buf)} rows bit-exact to the numpy decoder; decode of '
              f'32 clips on {card}: {ms:.4f} ms (median of 20)')
    adpcm_err, adpcm_times = adpcm_kernel_checks(card, dev, signals, wires)
    v_launches = a_launches = 0
    for name in ('adpcm4', 'q6'):
        buf = wires[name][:len(clips)]
        fused_logmel.launches = 0
        wire_ops._adpcm_decode.launches = 0
        reset_conv_counts()
        ev_gpu, xml_gpu = gpu.predict_clips(buf)
        launched = fused_logmel.launches
        assert launched > 0, f'the {name} wire did not launch the kernel'
        check_epilogues(f'[10] {name}', gpu.model, launched)
        v_launches += launched
        if name == 'adpcm4':
            a_launches = wire_ops._adpcm_decode.launches
            assert a_launches > 0, \
                'adpcm4 predict_clips did not launch the ADPCM kernel'
            print(f'[10] ADPCM kernel launches in adpcm4 predict_clips of '
                  f'{len(buf)} clips: {a_launches}')
        ev_cpu, xml_cpu = cpu.predict_clips(buf)
        assert ev_gpu == ev_cpu, f'{name} events differ between GPU and CPU'
        assert xml_gpu == xml_cpu, f'{name} XML differs between GPU and CPU'
        print(f'[10] predict_clips of {len(buf)} clips as {name} on {dev}: '
              f'{sum(map(len, ev_gpu))} events (int16: '
              f'{sum(map(len, ev_pcm))}), kernel launches {launched}; '
              f'events and XML identical to the CPU engine')
    adpcm_bench = np.concatenate([wires['adpcm4'][:len(clips)]] * 8)
    rates = {'int16': [], 'adpcm4': []}
    for name in ('int16', 'adpcm4', 'adpcm4', 'int16'):
        got, n_events = clips_per_s(
            gpu, bench if name == 'int16' else adpcm_bench, runs=2)
        rates[name] += [round(r, 1) for r in got]
    print(f'[10] predict_clips 512 clips, batch 32, on {card} (2 runs each, '
          f'in turns): adpcm4 {rates["adpcm4"]} clips/s, int16 '
          f'{rates["int16"]}; {n_events} events on int16')
    profile_batch(gpu, adpcm_bench[:32], '10')
    n = decode_profile(wire_ops.dequant_wire,
                       torch.from_numpy(adpcm_bench[:32]).to(dev), '10')
    assert 1 <= n <= 2, f'one adpcm4 decode of 32 clips took {n} launches'

    # -- 11. predict_clips_stream ------------------------------------------
    fused_logmel.launches = 0
    reset_conv_counts()
    stream_out = gpu.predict_clips_stream(
        bench[i:i + 32] for i in range(0, len(bench), 32))
    s_launches = fused_logmel.launches
    assert s_launches > 0, 'predict_clips_stream did not launch the kernel'
    check_epilogues('[11] predict_clips_stream', gpu.model, s_launches)
    assert stream_out == gpu.predict_clips(bench), \
        'predict_clips_stream differs from predict_clips'
    rates, n_events = clips_per_s(gpu, bench, stream_chunk=32)
    print(f'[11] predict_clips_stream 512 int16 clips in chunks of 32 on '
          f'{card}: identical to predict_clips, kernel launches '
          f'{s_launches}; {[round(r, 1) for r in rates]} clips/s (3 runs), '
          f'{n_events} events')
    # host work in the caller's iterator: 512 wav reads, 64 files x 8
    with tempfile.TemporaryDirectory() as tmp:
        for file_sr in (cfg.sample_rate, 44100):
            paths = []
            for i, clip in enumerate(make_clips(64, file_sr, seconds=5,
                                                seed=41)):
                paths.append(os.path.join(tmp, f'{file_sr}_{i}.wav'))
                audio_io.save_wav(paths[-1], clip, file_sr)
            rates = file_stream(gpu, paths * 8)
            print(f'[11] 512 wav files of 5 s at {file_sr} Hz read by '
                  f'load_audio (to {cfg.sample_rate} Hz) on {card}: '
                  f'stream equal to read-all + predict_clips; clips/s '
                  f'(3 runs each, in turns): read alone {rates["read"]}, '
                  f'read-all + predict_clips {rates["plain"]}, '
                  f'predict_clips_stream {rates["stream"]}')

    # -- 12. StreamingSed ----------------------------------------------------
    from sed_tpu_torch.serve.streaming import StreamingSed
    stream = make_clips(6, cfg.sample_rate, seconds=5, seed=31).reshape(-1)
    rng = np.random.RandomState(12)
    sess = StreamingSed(gpu, 'stream')
    fused_logmel.launches = 0
    reset_conv_counts()
    t0 = time.perf_counter()
    pos, feeds, early = 0, 0, []
    while pos < len(stream):
        size = int(rng.uniform(0.05, 3.0) * cfg.sample_rate)
        early.extend(sess.feed(stream[pos:pos + size]))
        pos += size
        feeds += 1
    got = early + sess.flush()
    wall = time.perf_counter() - t0
    r_launches = fused_logmel.launches
    assert r_launches > 0, 'StreamingSed did not launch the kernel'
    check_epilogues('[12] StreamingSed', gpu.model, r_launches)

    def keys(evs):
        return sorted((e['event_label'], round(e['onset'], 4),
                       round(e['offset'], 4)) for e in evs)

    want = keys(cpu.predict_waveform(stream, 'stream'))
    assert want and keys(got) == want, \
        'StreamingSed on the GPU differs from the CPU predict_waveform'
    print(f'[12] StreamingSed on {dev}: 30 s in {feeds} random chunks, '
          f'{len(got)} events ({len(early)} before the flush) equal to the '
          f'CPU engine\'s predict_waveform; kernel launches {r_launches}; '
          f'{wall:.3f} s wall')

    # -- 13. training on the card -------------------------------------------
    t13 = time.perf_counter()
    n_launch13, train_kernel = train_phase(card, dev, cfg, pcm)
    max_err = max([max_err] + [v[3] for v in train_kernel.values()])
    print(f'[13] training phase done in {time.perf_counter() - t13:.1f} s')

    # -- 14. the other model families ---------------------------------------
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    n_launch14 = families_phase(card, dev, cfg, pcm)
    print(f'[14] families phase done in {time.perf_counter() - t14:.1f} s')

    # -- 15. configs[3]: the gammatone feature, CQT and ISTFT ---------------
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    gamma_phase(card, dev)
    print(f'[15] gamma phase done in {time.perf_counter() - t15:.1f} s')

    # -- 16. the bf16 conv stack: serving and training ------------------------
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    n_launch16 = bf16_phase(card, dev, cfg, pcm, gpu)
    print(f'[16] bf16 phase done in {time.perf_counter() - t16:.1f} s')

    # -- 17. multi-device on the one card, and the CPU dry run ---------------
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    n_launch17 = parallel_phase(card, dev, cfg, pcm, gpu,
                                wires['adpcm4'][:len(clips)])
    print(f'[17] multi-device phase done in {time.perf_counter() - t17:.1f} s')

    # -- 18. resident file serving and the v6 wire ---------------------------
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    n_launch18, a_launches18, v6_kernel = resident_phase(card, dev, cfg,
                                                         clips, gpu, cpu)
    print(f'[18] resident phase done in {time.perf_counter() - t18:.1f} s')

    # -- 19. the training CLI's loop: learning against sed_tpu's checkpoint --
    torch.cuda.empty_cache()
    n_launch19, a_launches19 = learning_phase(card, dev, cfg, pcm)

    blocked = [m for m in sys.modules
               if m.split('.')[0] in ('sed_tpu', 'jax', 'jaxlib', 'flax',
                                      'optax', 'orbax')]
    assert not blocked, f'JAX or sed_tpu modules were imported: {blocked[:5]}'

    bound = bound_ms(cfg, (32, 80000), 501)
    print(json.dumps({'kernels': [{
        'name': 'fused_logmel', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/logmel.cu',
        'replaces': 'sed_tpu/ops/logmel_kernel.py:48',
        'launches': (launches + t_launches + w_launches + e_launches
                     + v_launches + s_launches + r_launches + n_launch13
                     + n_launch14 + n_launch16 + n_launch17 + n_launch18
                     + n_launch19),
        'max_abs_err': max_err,
        'ms': kernel_ms, 'plain_ms': plain_ms,
        'bound_ms': bound[0], 'bound_by': bound[1],
        # no single PyTorch call computes log-mel
        'library_ms': None}, {
        'name': 'v6_decode', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/v6_decode.cu',
        'replaces': 'sed_tpu/ops/wire.py:409',
        # no PyTorch call computes the v6 decode: library_ms is null
        **v6_kernel}, {
        'name': 'adpcm_decode', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/adpcm_decode.cu',
        'replaces': 'sed_tpu/ops/wire.py:335',
        'launches': a_launches + a_launches18 + a_launches19,
        'max_abs_err': adpcm_err,
        'ms': adpcm_times[4, 32][0], 'plain_ms': adpcm_times[4, 32][1],
        'bound_ms': adpcm_times[4, 32][2][0],
        'bound_by': adpcm_times[4, 32][2][1],
        # no PyTorch call decodes IMA ADPCM
        'library_ms': None}, {
        'name': 'conv_epilogue', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/conv_epilogue.cu',
        # sed_tpu leaves BatchNorm, ReLU and the pool to XLA's fusion
        'replaces': None,
        'launches': sum(epilogue_launches),
        # the sums over the 8 epilogues of a 32 x 5 s forward
        **epilogue,
        # no single PyTorch call computes BatchNorm, ReLU and the pool
        'library_ms': None}, {
        'name': 'conv3x3', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/conv3x3.cu',
        # sed_tpu leaves the convolutions to XLA
        'replaces': None,
        'launches': sum(conv3x3_launches),
        'packed_launches': sum(conv3x3_packed),
        # the sums over the 8 convolutions of a 32 x 5 s forward; the
        # library is cuDNN's fp32 F.conv2d under the measured choice
        **convs}]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
