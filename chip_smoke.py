#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, int16 5 s clips -> events -> XML through
``sed_tpu_torch.serve.engine.SedInferenceEngine`` with
Cnn_9layers_Gru_FrameAtt at 16 kHz on the trained bench checkpoint, and
checks it against the same engine on the CPU.  Phases:

1. card, power limit, torch / CUDA versions, TF32 flags (both turned off);
2. build of the CUDA log-mel kernel from ``sed_tpu_torch/csrc`` (nvcc,
   sm_90a), its time, and ptxas's registers and spills (no spills);
3. kernel against its plain PyTorch version at 8, 16 and 32 kHz, with a
   frame count no tile divides, near-silent, digitally silent and
   full-scale clips, and with a mel filter on the Nyquist bin (rtol 1e-4,
   atol 1e-3 dB);
4. ``predict_clips`` on 64 int16 bench-corpus clips on the GPU: the
   kernel's launch count must rise; events and XML identical to the CPU
   engine, framewise output within 1e-4;
5. ``predict_file`` on a 12 s wav (overlapped windows): events and XML
   identical to the CPU engine;
6. times on the GPU: kernel against plain log-mel at 8, 16 and 32 kHz,
   batch 1 and 32 of 5 s clips (CUDA events, median of 20, in turns),
   with the kernel's achieved TFLOP/s; ``predict_clips`` clips/s over 512
   clips at batch 32; a profiler breakdown of one batch.

Any failure raises (exit code != 0).  Without CUDA, or outside the
repository, it exits non-zero before printing a result.  The last line
is the JSON result; the line before it names the card and power limit.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-4, atol=1e-3)        # dB; tests/test_ops.py's tolerance
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


def kernel_inputs(cfg, seed: int):
    """Bench-corpus clips plus a near-silent (level 1e-4, as the corpus's
    near-silent backgrounds), a half digitally silent and a full-scale
    +-1.0 clip, 5 s plus a few hops so that no 64-frame tile divides the
    frame count."""
    import numpy as np
    from bench_corpus import make_clips
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


def useful_gflop(cfg, rows: int) -> float:
    """DFT and mel products of the function, per its shapes: rows frames
    @ (n_fft, 2 * bins), then @ (bins, mel_bins)."""
    n, bins = cfg.window_size, cfg.window_size // 2 + 1
    return rows * (2 * n * 2 * bins + 2 * bins * cfg.mel_bins) / 1e9


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA GPU')
    sys.path[:0] = [REPO, os.path.join(REPO, 'tools')]
    import numpy as np
    from sed_tpu_torch import _build
    from sed_tpu_torch._host import audio_io, config
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.dsp.frontend import logmel_plain
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    from sed_tpu_torch.serve.engine import (SedInferenceEngine, disable_tf32,
                                            tf32_flags)
    from bench_corpus import make_clips

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

    # -- 2. kernel build -------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load('logmel')
    print(f'[2] built {os.path.relpath(lib.path, REPO)} from '
          f'sed_tpu_torch/csrc/{{logmel.cu,mma_sm90.cuh}} with nvcc '
          f'{" ".join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.2f} '
          f's (nvcc {lib.build_seconds:.2f} s)')
    for line in lib.build_log.splitlines():
        print(f'[2]   {line}')
    regs = [int(r) for r in re.findall(r'Used (\d+) registers',
                                        lib.build_log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r'(\d+) bytes spill stores, (\d+) bytes spill loads', lib.build_log)]
    print(f'[2] ptxas: registers {regs}, spill bytes {spills}')
    assert regs and spills and not any(spills), 'ptxas spilled registers'

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
    ev_gpu, xml_gpu = gpu.predict_clips(pcm)
    launches = fused_logmel.launches
    print(f'[4] predict_clips on {dev}: {len(pcm)} clips, '
          f'{sum(map(len, ev_gpu))} events, log-mel kernel launches '
          f'{launches}')
    assert launches > 0, 'the main path did not launch the log-mel kernel'
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
            got, want = fused_logmel(wav, rate), logmel_plain(wav, rate)
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, **TOL)
            max_err = max(max_err, err)
            times = {}
            for name, fn in (('plain', logmel_plain),
                             ('kernel', fused_logmel),
                             ('kernel', fused_logmel),
                             ('plain', logmel_plain)):
                times.setdefault(name, []).append(
                    cuda_ms(lambda: fn(wav, rate)))
            best = min(times['kernel'])
            gflop = useful_gflop(rate, batch * got.shape[1])
            tensor = 2 * batch * got.shape[1] * rate.window_size ** 2
            print(f'[6] log-mel {rate.name} {batch} x {wav.shape[1]} on '
                  f'{card}: kernel {times["kernel"]} ms, plain '
                  f'{times["plain"]} ms (median of 20 each, in turns); '
                  f'kernel {gflop / best:.1f} TFLOP/s useful '
                  f'({gflop:.3f} GFLOP), fp64 DFT '
                  f'{tensor / best / 1e9:.1f} TFLOP/s on the tensor cores; '
                  f'max |kernel - plain| {err!r} dB')
            if rate is cfg and batch == 32:     # the main path's batch
                kernel_ms, plain_ms = best, min(times['plain'])

    bench = np.concatenate([pcm] * 8)                      # 512 clips
    gpu.predict_clips(bench[:64])                          # warm-up
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev, _ = gpu.predict_clips(bench)
        rates.append(len(bench) / (time.perf_counter() - t0))
    print(f'[6] predict_clips 512 int16 clips, batch 32, on {card}: '
          f'{[round(r, 1) for r in rates]} clips/s (3 runs), '
          f'{sum(map(len, ev))} events')

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.predict_clips(pcm[:32])
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f'[6] profile of predict_clips(32 clips): wall {wall_us:.0f} us, '
          f'device kernels {busy_us:.0f} us, device idle share '
          f'{1 - busy_us / wall_us:.3f}')
    for e in rows[:12]:
        print(f'[6]   {e.self_device_time_total:10.0f} us  x{e.count:<4d} '
              f'{e.key[:90]}')

    blocked = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                      'orbax')]
    assert not blocked, f'JAX modules were imported: {blocked[:5]}'

    print(json.dumps({'kernels': [{
        'name': 'fused_logmel', 'route': 'cuda',
        'source': 'sed_tpu_torch/csrc/logmel.cu',
        'replaces': 'sed_tpu/ops/logmel_kernel.py:48',
        'launches': launches, 'max_abs_err': max_err,
        'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
