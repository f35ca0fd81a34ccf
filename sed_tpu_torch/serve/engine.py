"""SED serving engine: wav -> events -> XML (counterpart of
``sed_tpu/serve/engine.py``).

All overlapped windows of a file, and the windows of many files, are
batched into shared forwards on the engine's device; event decoding and
XML stay on the host.  ``predict_clips`` keeps the framewise output on
the device: it is coverage-normalised and reduced to per-track maxima
there, and only the threshold masks of the active (clip, class) tracks
come back to the host.

Window schedule (reference ``predict.py:296-338``): windows advance 1 s
with ``overlap`` else ``sample_duration`` s; window n >= 1 runs only
while ``start + sample_duration <= duration``; a short file still gets
one zero-padded window.

Numerics: the reference runs fp32 products.  On a GPU, PyTorch runs
cuDNN convolutions in TF32 unless told otherwise, so a CUDA engine
refuses to start while either TF32 flag is on; ``disable_tf32()`` turns
both off.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_tpu_torch._host import (audio_io, config, events as post_events,
                                 merge as post_merge, vad, vad_native,
                                 xml_writer)
from sed_tpu_torch.ops import wire as wire_ops


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls in full fp32 on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_flags() -> dict:
    return {'cuda.matmul.allow_tf32': torch.backends.cuda.matmul.allow_tf32,
            'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32}


def window_starts(duration: float, sample_duration: int,
                  overlap: bool, step: Optional[float] = None
                  ) -> List[float]:
    """Start offsets (seconds) of the reference's sliding-window loop;
    ``step`` overrides the hop (1 s with ``overlap``, else a window)."""
    if step is None:
        step = 1 if overlap else sample_duration
    starts = [0.0]
    start = step
    while start + sample_duration <= duration:
        starts.append(float(start))
        start += step
    return starts


class SedInferenceEngine:
    """Batched inference of a port model on an explicit device.

    Args:
      model: a ``sed_tpu_torch`` model (e.g. from ``from_flax.load_npz``).
      cfg: audio quality config.
      device: where the forward runs ('cpu', 'cuda', 'cuda:1', ...).  The
        model is moved there.  A CUDA device that is absent raises.
      sample_duration: window length in seconds.
      overlap: 1 s window hop when True, else non-overlapped windows.
      overlap_value: merge hop in seconds.
      sed_params: event-decoding thresholds.
      batch_size: clips per forward.
      labels: class names, indexed by class.
    """

    def __init__(self, model: torch.nn.Module, cfg, device,
                 sample_duration: int = 5, overlap: bool = True,
                 overlap_value: float = 1.0,
                 sed_params: config.SedParams = config.PREDICT_SED_PARAMS,
                 batch_size: int = 32,
                 labels: Sequence[str] = config.LABELS):
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError(f'device {self.device} requested but '
                                   'CUDA is not available')
            if any(tf32_flags().values()):
                raise RuntimeError(
                    f'TF32 is on ({tf32_flags()}); the engine computes in '
                    'fp32: call sed_tpu_torch.serve.engine.disable_tf32()')
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.sample_duration = sample_duration
        self.overlap = overlap
        self.overlap_value = overlap_value
        self.sed_params = sed_params
        self.batch_size = batch_size
        self.labels = labels
        self.window_samples = cfg.sample_rate * sample_duration
        self.dispatch_ahead_batches = 64   # bounds live device buffers

        self._params = sed_params.per_class(len(labels))
        self._high_dev = torch.tensor(self._params['sed_high_threshold'],
                                      dtype=torch.float32, device=self.device)
        self._low_dev = torch.tensor(self._params['sed_low_threshold'],
                                     dtype=torch.float32, device=self.device)
        self._out_frames = self._clip_out_frames()
        self._coverage = torch.tensor(
            post_merge.coverage_counts(self._out_frames, sample_duration,
                                       overlap_value),
            dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def _clip_out_frames(self) -> int:
        """Framewise output length for one window, from the model."""
        wav = torch.zeros((1, self.window_samples), device=self.device)
        return self.model(wav)['framewise_output'].shape[1]

    @torch.inference_mode()
    def _forward(self, wire: np.ndarray):
        wav = wire_ops.dequant_wire(
            torch.from_numpy(np.ascontiguousarray(wire)).to(self.device))
        out = self.model(wav)
        return out['framewise_output'], out['clipwise_output']

    # ------------------------------------------------------------------
    # core batched forward
    # ------------------------------------------------------------------

    def infer_framewise(self, wavs: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, window_samples) wire -> (framewise (N, T, C), clipwise
        (N, C)) as numpy."""
        outs = [self._forward(wavs[i:i + self.batch_size])
                for i in range(0, wavs.shape[0], self.batch_size)]
        framewise = torch.cat([f for f, _ in outs]).cpu().numpy()
        clipwise = torch.cat([c for _, c in outs]).cpu().numpy()
        return framewise, clipwise

    # ------------------------------------------------------------------
    # file / waveform prediction
    # ------------------------------------------------------------------

    def _windows(self, audio: np.ndarray, starts: List[float]):
        sr = self.cfg.sample_rate
        return [audio_io.pad_truncate(
            audio[int(s * sr):int(s * sr) + self.window_samples],
            self.window_samples) for s in starts]

    def predict_waveform(self, audio: np.ndarray,
                         audio_name: str = 'audio',
                         duration: Optional[float] = None,
                         step: Optional[float] = None) -> List[dict]:
        """Full waveform (at cfg.sample_rate) -> event list.

        Reference quirk kept: windows are merged at ``overlap_value``-s
        offsets even when they hop ``sample_duration`` s.
        """
        return self.predict_waveforms([audio], [audio_name], duration, step)

    def predict_waveforms(self, waveforms, names,
                          duration: Optional[float] = None,
                          step: Optional[float] = None) -> List[dict]:
        """Many full waveforms -> one event list, the windows of all files
        batched into shared forwards."""
        sr = self.cfg.sample_rate
        all_windows = []
        spans = []      # (name, first window, n_windows)
        for audio, name in zip(waveforms, names):
            dur = duration if duration is not None else len(audio) / float(sr)
            starts = window_starts(dur, self.sample_duration, self.overlap,
                                   step)
            spans.append((name, len(all_windows), len(starts)))
            all_windows.extend(self._windows(audio, starts))
        framewise, _ = self.infer_framewise(audio_io.stack_rows(all_windows))
        events: List[dict] = []
        for name, i0, n_win in spans:
            merged = post_merge.overlap_add_windows(
                framewise[i0:i0 + n_win], self.sample_duration,
                self.overlap_value)
            events.extend(post_events.frame_prediction_to_event_prediction_v2(
                merged, name, self.sed_params, self.cfg.frames_per_second,
                self.labels))
        return events

    def fallback_span(self, duration: float) -> Tuple[float, float]:
        """The reference's "Others" span for a file with no events: the
        post-loop window start (which can lie past the end of a short
        file) to min(duration, start + sample_duration)."""
        starts = window_starts(duration, self.sample_duration, self.overlap)
        last_start = starts[-1] + (1 if self.overlap
                                   else self.sample_duration)
        return last_start, min(duration, last_start + self.sample_duration)

    def predict_file(self, path: str) -> Tuple[List[dict], str]:
        """Audio file -> (event list sorted by onset, XML string)."""
        audio, _ = audio_io.load_audio(path, sr=self.cfg.sample_rate)
        duration = len(audio) / float(self.cfg.sample_rate)
        name = os.path.basename(path)
        events = sorted(self.predict_waveform(audio, name),
                        key=lambda e: e['onset'])
        xml = xml_writer.events_to_xml(
            events, name, fallback_span=self.fallback_span(duration))
        return events, xml

    # ------------------------------------------------------------------
    # bulk clip API
    # ------------------------------------------------------------------

    def _decode_tracks_into(self, per_clip: List[List[dict]],
                            names: List[str], high_packed: np.ndarray,
                            low_packed: np.ndarray, act_n: np.ndarray,
                            act_c: np.ndarray) -> None:
        """Decode packed threshold masks of active (clip, class) tracks
        into per-clip event dicts (native decoder when it is built)."""
        p = self._params
        t_frames = self._out_frames
        if vad_native.native_available():
            all_pairs = vad_native.decode_packed_tracks(
                high_packed, low_packed, t_frames,
                np.asarray(p['n_smooth'], np.int32)[act_c],
                np.asarray(p['n_salt'], np.int32)[act_c])
        else:
            high = np.unpackbits(high_packed, axis=1)[:, :t_frames]
            low = np.unpackbits(low_packed, axis=1)[:, :t_frames]
            all_pairs = [
                vad.activity_detection_masks(
                    high[j].astype(bool), low[j].astype(bool),
                    n_smooth=p['n_smooth'][int(act_c[j])],
                    n_salt=p['n_salt'][int(act_c[j])])
                for j in range(act_n.size)]
        fps = float(self.cfg.frames_per_second)
        for j, pairs in enumerate(all_pairs):
            clip_i = int(act_n[j])
            for bgn, fin in pairs:
                per_clip[clip_i].append({
                    'filename': names[clip_i],
                    'onset': bgn / fps,
                    'offset': fin / fps,
                    'event_label': self.labels[int(act_c[j])]})

    @torch.inference_mode()
    def predict_clips(self, wavs: np.ndarray,
                      names: Optional[List[str]] = None
                      ) -> Tuple[List[List[dict]], List[str]]:
        """N fixed-length clips (N, window_samples), int16 or float32 ->
        per-clip (events, XML).

        One window per clip.  On the device: forward, coverage
        normalisation, per-track max.  One pull of the (N, C) maxima picks
        the active tracks (max > high threshold); their high/low masks
        (``>`` high, ``>=`` low, float32 thresholds) are made on the
        device and pulled in one transfer.
        """
        n = wavs.shape[0]
        if names is None:
            names = [f'clip{i}.wav' for i in range(n)]
        limit = self.dispatch_ahead_batches * self.batch_size
        if n > limit:
            per_clip, xmls = [], []
            for i in range(0, n, limit):
                ev, xm = self.predict_clips(wavs[i:i + limit],
                                            names[i:i + limit])
                per_clip.extend(ev)
                xmls.extend(xm)
            return per_clip, xmls
        if wavs.ndim != 2 or wavs.shape[1] != self.window_samples:
            raise ValueError(f'predict_clips wants (N, {self.window_samples})'
                             f' clips, got {wavs.shape}')
        high = np.asarray(self._params['sed_high_threshold'], np.float64)

        framewise = []
        for i0 in range(0, n, self.batch_size):
            fw, _ = self._forward(wavs[i0:i0 + self.batch_size])
            framewise.append(fw / self._coverage[None, :, None])
        framewise = torch.cat(framewise)                    # (N, T, C)
        track_max = framewise.amax(dim=1).cpu().numpy()     # one pull

        act_n, act_c = np.nonzero(track_max > high[None, :])
        per_clip: List[List[dict]] = [[] for _ in range(n)]
        if act_n.size:
            idx_n = torch.from_numpy(act_n).to(self.device)
            idx_c = torch.from_numpy(act_c).to(self.device)
            tracks = framewise[idx_n, :, idx_c]             # (K, T)
            masks = torch.cat([tracks > self._high_dev[idx_c][:, None],
                               tracks >= self._low_dev[idx_c][:, None]])
            masks = masks.cpu().numpy()                     # one pull
            k = act_n.size
            self._decode_tracks_into(
                per_clip, names, np.packbits(masks[:k], axis=1),
                np.packbits(masks[k:], axis=1), act_n, act_c)

        xmls = [xml_writer.events_to_xml(
                    sorted(evs, key=lambda e: e['onset']), names[i],
                    fallback_span=(0, self.sample_duration))
                for i, evs in enumerate(per_clip)]
        return per_clip, xmls
