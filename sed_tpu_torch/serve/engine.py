"""SED serving engine: wav -> events -> XML (counterpart of
``sed_tpu/serve/engine.py``).

All overlapped windows of a file, and the windows of many files, are
batched into shared forwards on the engine's device; event decoding and
XML stay on the host.  ``predict_clips``, ``predict_clips_stream`` and
``predict_clips_windowed`` keep the framewise output on the device: it
is overlap-added (windowed), coverage-normalised and reduced to
per-track maxima there, and only the threshold masks of the active
(clip, class) tracks come back to the host.

Wires: ``predict_clips``, ``predict_clips_stream`` and
``infer_framewise`` take float32, int16 or any uint8 wire of
``ops/wire.py`` (mu-law, qN, ADPCM), decoded on the device;
``predict_clips_windowed`` takes the same wires of its whole clips, with
``clip_samples`` naming their decoded length.

Window schedule (reference ``predict.py:296-338``): windows advance 1 s
with ``overlap`` else ``sample_duration`` s; window n >= 1 runs only
while ``start + sample_duration <= duration``; a short file still gets
one zero-padded window.

Several devices (``devices=[...]``, ``sed_tpu``'s ``mesh``): one process
keeps a replica of the caller's model on each device, splits every
batch into even, contiguous shares, launches each share's forward on its
device before it reads any result, and gathers the framewise output in
order onto the first device, where the device -> host tail runs as with
one device.

Numerics: the reference runs fp32 products.  On a GPU, PyTorch runs
cuDNN convolutions in TF32 unless told otherwise, so a CUDA engine
refuses to start while either TF32 flag is on; ``disable_tf32()`` turns
both off.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_tpu_torch import config
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.native import vad_native
from sed_tpu_torch.post import events as post_events
from sed_tpu_torch.post import merge as post_merge
from sed_tpu_torch.post import vad, xml_writer
from sed_tpu_torch.ops import wire as wire_ops


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls in full fp32 on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_flags() -> dict:
    return {'cuda.matmul.allow_tf32': torch.backends.cuda.matmul.allow_tf32,
            'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32}


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises when CUDA is
    absent or while TF32 is on (the port computes in fp32)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device} requested but CUDA is not '
                               'available')
        if any(tf32_flags().values()):
            raise RuntimeError(
                f'TF32 is on ({tf32_flags()}); the port computes in fp32: '
                'call sed_tpu_torch.serve.engine.disable_tf32()')
    return device


def refuse_features(feature_type: str, what: str) -> None:
    """Serving feeds waveforms: a model on packed gammatone features
    (``feature_type='gamma'``) cannot run there.  ``sed_tpu`` fails on
    it too, deep in the forward; this raises up front."""
    if feature_type != 'logmel':
        raise ValueError(
            f"{what} feeds waveforms; a feature_type={feature_type!r} model "
            'takes packed features (evaluate it with inference_prob)')


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
    """Batched inference of a port model on the card, or on the device
    the caller names.

    Args:
      model: a ``sed_tpu_torch`` model (e.g. from ``from_flax.load_npz``).
      cfg: audio quality config.
      device: where the forward runs ('cuda' by default; 'cpu', 'cuda:1',
        ...).  The model is moved there.  A CUDA device that is absent
        raises: there is no fallback to the CPU.
      sample_duration: window length in seconds.
      overlap: 1 s window hop when True, else non-overlapped windows.
      overlap_value: merge hop in seconds.
      sed_params: event-decoding thresholds.
      batch_size: clips per forward.
      labels: class names, indexed by class.
      devices: several devices to serve on (e.g. ``['cuda:0', 'cuda:1']``),
        in place of ``device``: a replica of ``model`` on each, every batch
        split over them; ``batch_size`` must divide evenly over them.
    """

    def __init__(self, model: torch.nn.Module, cfg, device='cuda',
                 sample_duration: int = 5, overlap: bool = True,
                 overlap_value: float = 1.0,
                 sed_params: config.SedParams = config.PREDICT_SED_PARAMS,
                 batch_size: int = 32,
                 labels: Sequence[str] = config.LABELS,
                 devices: Optional[Sequence] = None):
        refuse_features(getattr(model, 'feature_type', 'logmel'),
                        'SedInferenceEngine')
        if devices is not None:
            if not devices or batch_size % len(devices):
                raise ValueError(f'batch_size {batch_size} must divide '
                                 f'evenly over {len(devices)} devices')
            device = devices[0]
        self.devices = [check_device(d)
                        for d in (devices if devices else [device])]
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        # one replica a further device (the caller's model on the first)
        self.replicas = [self.model] + [
            copy.deepcopy(self.model).to(d).eval() for d in self.devices[1:]]
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

    def _shares(self, rows: np.ndarray, fn):
        """``fn(model, rows on its device)`` -> tuple of tensors, for each
        replica's even, contiguous share of ``rows``: every share's work
        is launched before any result is read, then each output is
        gathered in order onto the first device."""
        if len(self.replicas) == 1:
            return fn(self.model, torch.from_numpy(
                np.ascontiguousarray(rows)).to(self.device))
        outs = [fn(model, torch.from_numpy(np.ascontiguousarray(share))
                   .to(dev))
                for model, dev, share in zip(
                    self.replicas, self.devices,
                    np.array_split(rows, len(self.replicas)))
                if len(share)]
        return tuple(torch.cat([o[i].to(self.device) for o in outs])
                     for i in range(len(outs[0])))

    @torch.inference_mode()
    def _forward(self, wire: np.ndarray):
        def run(model, rows):
            out = model(wire_ops.dequant_wire(rows,
                                              samples=self.window_samples))
            return out['framewise_output'], out['clipwise_output']
        return self._shares(wire, run)

    def _check_clip_widths(self, wavs: np.ndarray) -> None:
        """(N, W) clips whose width is ``window_samples`` or a uint8
        wire's for it."""
        widths = {self.window_samples}
        if wavs.dtype == np.uint8:
            widths.update(wire_ops.wire_widths(self.window_samples))
        if wavs.ndim != 2 or wavs.shape[1] not in widths:
            raise ValueError(f'predict_clips wants (N, {self.window_samples})'
                             f' clips or a uint8 wire of theirs '
                             f'({sorted(widths)}), got {wavs.shape} '
                             f'{wavs.dtype}')

    # ------------------------------------------------------------------
    # core batched forward
    # ------------------------------------------------------------------

    def infer_framewise(self, wavs: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, W) clips of ``window_samples``, float32 / int16 or a uint8
        wire -> (framewise (N, T, C), clipwise (N, C)) as numpy."""
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
                            act_c: np.ndarray, t_frames: int) -> None:
        """Decode packed threshold masks of active (clip, class) tracks
        into per-clip event dicts (native decoder when it is built)."""
        p = self._params
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

    def _events_on_device(self, framewise: torch.Tensor,
                          names: List[str]) -> List[List[dict]]:
        """Coverage-normalised (N, T, C) framewise output on the device ->
        per-clip event lists.

        One pull of the (N, C) track maxima picks the active tracks
        (max > high threshold); their high/low masks (``>`` high, ``>=``
        low, float32 thresholds) are made on the device and pulled in one
        transfer, then decoded on the host.
        """
        n, t_frames, _ = framewise.shape
        high = np.asarray(self._params['sed_high_threshold'], np.float64)
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
                np.packbits(masks[k:], axis=1), act_n, act_c, t_frames)
        return per_clip

    @torch.inference_mode()
    def predict_clips(self, wavs: np.ndarray,
                      names: Optional[List[str]] = None
                      ) -> Tuple[List[List[dict]], List[str]]:
        """N fixed-length clips (N, window_samples) float32 / int16, or
        their uint8 wire of any width in ``wire_widths(window_samples)``
        -> per-clip (events, XML).

        One window per clip.  On the device: wire decode, forward,
        coverage normalisation, per-track max; then
        ``_events_on_device``.
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
        self._check_clip_widths(wavs)

        framewise = []
        for i0 in range(0, n, self.batch_size):
            fw, _ = self._forward(wavs[i0:i0 + self.batch_size])
            framewise.append(fw / self._coverage[None, :, None])
        per_clip = self._events_on_device(torch.cat(framewise), names)
        return per_clip, self._clip_xmls(per_clip, names)

    def _clip_xmls(self, per_clip: List[List[dict]],
                   names: List[str]) -> List[str]:
        return [xml_writer.events_to_xml(
                    sorted(evs, key=lambda e: e['onset']), names[i],
                    fallback_span=(0, self.sample_duration))
                for i, evs in enumerate(per_clip)]

    @torch.inference_mode()
    def predict_clips_stream(self, chunk_iter: Iterable[np.ndarray],
                             names: Optional[List[str]] = None
                             ) -> Tuple[List[List[dict]], List[str]]:
        """Pipelined ``predict_clips`` over a stream of clip chunks
        (counterpart of ``sed_tpu``'s ``predict_clips_stream``).

        ``chunk_iter`` yields (n_i, W) arrays, n_i <= batch_size, of any
        wire ``predict_clips`` accepts; ``names`` spans the concatenated
        stream.  A reader thread drains the caller's iterator (its file
        reads and host decode) into a queue of two chunks, so that it
        overlaps the device; this thread runs the forward and
        ``_events_on_device`` of each chunk as it comes.  The results
        equal ``predict_clips`` on the concatenation.  An exception in
        the iterator is raised here once the thread has ended.

        When this thread stops early (a bad chunk, a failed forward), the
        reader pulls no further chunk and closes the iterator if it has a
        ``close`` (a generator's ``finally`` blocks run).  A reader that
        is inside the iterator's own ``next()`` is waited for at most
        2 s; it then finishes that one ``next()`` in the background,
        closes the iterator and ends.
        """
        err: List[BaseException] = []
        stop = threading.Event()
        chunks: queue.Queue = queue.Queue(maxsize=2)

        def put(item) -> bool:
            # a bounded put that notices a consumer that has gone
            while not stop.is_set():
                try:
                    chunks.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            it = None
            try:
                it = iter(chunk_iter)
                for chunk in it:
                    if not put(chunk):
                        break
            except BaseException as e:          # raised in the caller
                err.append(e)
            finally:
                try:
                    if hasattr(it, 'close'):
                        it.close()
                except BaseException as e:
                    err.append(e)
                put(None)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        per_clip: List[List[dict]] = []
        try:
            while True:
                chunk = chunks.get()
                if chunk is None:
                    break
                if chunk.shape[0] > self.batch_size:
                    raise ValueError(f'a chunk of {chunk.shape[0]} clips '
                                     f'exceeds batch_size '
                                     f'{self.batch_size}')
                self._check_clip_widths(chunk)
                i0 = len(per_clip)
                fw, _ = self._forward(chunk)
                chunk_names = (names[i0:i0 + len(chunk)] if names is not None
                               else [f'clip{i}.wav'
                                     for i in range(i0, i0 + len(chunk))])
                per_clip.extend(self._events_on_device(
                    fw / self._coverage[None, :, None], chunk_names))
        finally:
            # unwind on any exit: wake a reader parked on the full queue
            stop.set()
            while True:
                try:
                    chunks.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=2.0)
        if err:
            raise err[0]
        if names is None:
            names = [f'clip{i}.wav' for i in range(len(per_clip))]
        return per_clip, self._clip_xmls(per_clip, names)

    @torch.inference_mode()
    def predict_clips_windowed(self, wavs: np.ndarray, names: List[str],
                               duration: float, step: float,
                               clip_samples: Optional[int] = None
                               ) -> List[List[dict]]:
        """Uniform-length clips (N, samples), float32 / int16, or their
        uint8 wire with ``clip_samples`` naming the decoded length (the
        wire is narrower) -> per-clip events, with overlapped windows
        merged on the device (the ``inference_prob_overlap`` path;
        counterpart of ``sed_tpu``'s ``predict_clips_windowed``).

        Windows start at ``window_starts(duration, sample_duration, True,
        step)``, sliced on the device at ``int(start * sr)`` samples.  Per
        chunk of ``max(1, batch_size // W)`` clips: one upload, one
        forward of all their W windows, overlap-add at ``int(100 * step)``
        frame offsets into ``t_win + (W - 1) * interval`` frames, division
        by ``merge.coverage_counts``; then ``_events_on_device``.
        """
        n = wavs.shape[0]
        if clip_samples is None:
            clip_samples = wavs.shape[-1]
        limit = self.dispatch_ahead_batches * self.batch_size
        if n > limit:
            out: List[List[dict]] = []
            for i in range(0, n, limit):
                out.extend(self.predict_clips_windowed(
                    wavs[i:i + limit], names[i:i + limit], duration, step,
                    clip_samples))
            return out
        starts = window_starts(duration, self.sample_duration, True, step)
        sr = self.cfg.sample_rate
        offs = [int(s * sr) for s in starts]
        if wavs.ndim != 2 or offs[-1] + self.window_samples > clip_samples:
            raise ValueError(f'{duration} s of {self.sample_duration} s '
                             f'windows at {step} s steps do not fit clips '
                             f'of shape {wavs.shape} ({clip_samples} '
                             'samples)')
        w_count = len(offs)
        interval = int(100 * step)
        t_win = self._out_frames
        total = t_win + (w_count - 1) * interval
        coverage = torch.tensor(
            post_merge.coverage_counts(total, self.sample_duration, step),
            dtype=torch.float32, device=self.device)

        def run(model, rows):
            clips = wire_ops.dequant_wire(rows, clip_samples)
            wins = torch.stack([clips[:, o:o + self.window_samples]
                                for o in offs], dim=1)   # (nc, W, samples)
            return model(wins.reshape(-1, self.window_samples))[
                'framewise_output'].view(len(rows), w_count, t_win, -1),

        nc = max(1, self.batch_size // w_count)
        merged = []
        for i0 in range(0, n, nc):
            fw, = self._shares(wavs[i0:i0 + nc], run)
            acc = fw.new_zeros((fw.shape[0], total, fw.shape[-1]))
            for w in range(w_count):
                acc[:, w * interval:w * interval + t_win] += fw[:, w]
            merged.append(acc / coverage[None, :, None])
        return self._events_on_device(torch.cat(merged), names)
