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

Resident passes (``predict_clips_resident``, ``predict_files_resident``):
a whole pass is copied to the device at once from pinned host memory
(file reads in threads straight into it), and every batch is sliced,
decoded and run there before one pull.  The v6 wire has a byte length per
clip, so its pass (``predict_files_resident_ragged``,
``predict_rows_resident``) uploads one flat pool of the true bytes and
the clips' offsets, and ``ops.wire.dequant_v6_pool`` decodes each batch.
``sed_tpu``'s knobs for its remote link (launch groups and chunks, pull
formats, upload deadlines) have no counterpart: on the card the upload is
a small share of a batch.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sed_tpu_torch import config
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.native import vad_native
from sed_tpu_torch.post import events as post_events
from sed_tpu_torch.post import merge as post_merge
from sed_tpu_torch.post import vad, xml_writer
from sed_tpu_torch.ops import wire as wire_ops
from sed_tpu_torch.utils.profiling import span


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

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def warmup(self, example: Optional[np.ndarray] = None) -> None:
        """One batched forward in the wire format of ``example`` (a
        (batch_size, W) batch; float32 zeros by default), so that the
        kernels are built and cuDNN has timed and chosen its algorithms
        for that shape before a timed call."""
        z = example if example is not None else np.zeros(
            (self.batch_size, self.window_samples), np.float32)
        assert z.shape[0] == self.batch_size, (z.shape, self.batch_size)
        self._check_clip_widths(z)
        self._forward(z)
        self._sync()

    @staticmethod
    def _share(model, rows: np.ndarray, device: torch.device, fn):
        """Host rows -> ``device`` (the ``sed::serve.upload`` span), then
        ``fn(model, rows)`` (the ``sed::serve.forward`` span)."""
        with span('serve.upload'):
            rows = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
        with span('serve.forward'):
            return fn(model, rows)

    def _shares(self, rows: np.ndarray, fn):
        """``fn(model, rows on its device)`` -> tuple of tensors, for each
        replica's even, contiguous share of ``rows``: every share's work
        is launched before any result is read, then each output is
        gathered in order onto the first device."""
        if len(self.replicas) == 1:
            return self._share(self.model, rows, self.device, fn)
        outs = [self._share(model, share, dev, fn)
                for model, dev, share in zip(
                    self.replicas, self.devices,
                    np.array_split(rows, len(self.replicas)))
                if len(share)]
        return tuple(torch.cat([o[i].to(self.device) for o in outs])
                     for i in range(len(outs[0])))

    def _run(self, model: torch.nn.Module, rows: torch.Tensor):
        """Wire rows (or decoded float32 rows) already on ``model``'s
        device -> (framewise, clipwise) on that device."""
        out = model(wire_ops.dequant_wire(rows, samples=self.window_samples))
        return out['framewise_output'], out['clipwise_output']

    def _run_covered(self, model: torch.nn.Module, rows: torch.Tensor):
        """``_run`` with the framewise output divided by one window's
        coverage."""
        framewise, clipwise = self._run(model, rows)
        return (framewise / self._coverage.to(framewise.device)[None, :, None],
                clipwise)

    @torch.inference_mode()
    def _forward(self, wire: np.ndarray, cover: bool = False):
        return self._shares(wire, self._run_covered if cover else self._run)

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

    def _pull_tracks(self, framewise: torch.Tensor,
                     into: Optional[dict] = None):
        """Coverage-normalised (N, T, C) framewise output on the device ->
        (active clip and class indices, their packed high and low masks
        on the host, bytes pulled).

        One pull of the (N, C) track maxima picks the active tracks
        (max > high threshold); their high/low masks (``>`` high, ``>=``
        low, float32 thresholds) are made on the device and pulled in one
        transfer.  The ``sed::serve.pull`` span (into ``into['pull_s']``).
        """
        with span('serve.pull', into, 'pull_s'):
            high = np.asarray(self._params['sed_high_threshold'], np.float64)
            track_max = framewise.amax(dim=1).cpu().numpy()     # one pull
            act_n, act_c = np.nonzero(track_max > high[None, :])
            pulled = track_max.nbytes
            if not act_n.size:
                return act_n, act_c, None, None, pulled
            idx_n = torch.from_numpy(act_n).to(self.device)
            idx_c = torch.from_numpy(act_c).to(self.device)
            tracks = framewise[idx_n, :, idx_c]                 # (K, T)
            masks = torch.cat([tracks > self._high_dev[idx_c][:, None],
                               tracks >= self._low_dev[idx_c][:, None]])
            masks = masks.cpu().numpy()                         # one pull
            k = act_n.size
            return (act_n, act_c, np.packbits(masks[:k], axis=1),
                    np.packbits(masks[k:], axis=1), pulled + masks.nbytes)

    def _decode_pulled(self, pulled, n: int, names: List[str],
                       t_frames: int, into: Optional[dict] = None
                       ) -> List[List[dict]]:
        """The pulled masks -> per-clip event dicts: the
        ``sed::serve.decode`` span (into ``into['decode_s']``)."""
        with span('serve.decode', into, 'decode_s'):
            act_n, act_c, high_packed, low_packed, _ = pulled
            per_clip: List[List[dict]] = [[] for _ in range(n)]
            if act_n.size:
                self._decode_tracks_into(per_clip, names, high_packed,
                                         low_packed, act_n, act_c, t_frames)
            return per_clip

    def _events_on_device(self, framewise: torch.Tensor,
                          names: List[str]) -> List[List[dict]]:
        """Coverage-normalised (N, T, C) framewise output on the device ->
        per-clip event lists: ``_pull_tracks``, then the host decode."""
        n, t_frames, _ = framewise.shape
        return self._decode_pulled(self._pull_tracks(framewise), n, names,
                                   t_frames)

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

        framewise = [self._forward(wavs[i0:i0 + self.batch_size],
                                   cover=True)[0]
                     for i0 in range(0, n, self.batch_size)]
        per_clip = self._events_on_device(torch.cat(framewise), names)
        return per_clip, self._clip_xmls(per_clip, names)

    def _clip_xmls(self, per_clip: List[List[dict]], names: List[str],
                   into: Optional[dict] = None) -> List[str]:
        """One XML document a clip: the ``sed::serve.xml`` span (into
        ``into['decode_s']``)."""
        with span('serve.xml', into, 'decode_s'):
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
                if not len(chunk):          # adds no clips, runs no forward
                    continue
                i0 = len(per_clip)
                fw, _ = self._forward(chunk, cover=True)
                chunk_names = (names[i0:i0 + len(chunk)] if names is not None
                               else [f'clip{i}.wav'
                                     for i in range(i0, i0 + len(chunk))])
                per_clip.extend(self._events_on_device(fw, chunk_names))
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
            fw = model(wins.reshape(-1, self.window_samples))[
                'framewise_output'].view(len(rows), w_count, t_win, -1)
            acc = fw.new_zeros((fw.shape[0], total, fw.shape[-1]))
            for w in range(w_count):
                acc[:, w * interval:w * interval + t_win] += fw[:, w]
            return acc / coverage.to(acc.device)[None, :, None],

        nc = max(1, self.batch_size // w_count)
        merged = [self._shares(wavs[i0:i0 + nc], run)[0]
                  for i0 in range(0, n, nc)]
        return self._events_on_device(torch.cat(merged), names)

    # ------------------------------------------------------------------
    # resident passes: one upload of a whole pass, every batch's decode
    # and forward on the device, one pull
    # ------------------------------------------------------------------

    _RAGGED_TAIL_WORDS = 2048   # zero tail of a v6 pool: it bounds the
    # worst-case header and data gathers past the last payload

    def _single_device(self, what: str) -> None:
        if len(self.devices) > 1:
            raise ValueError(f'{what} serves on one device; this engine '
                             f'has {len(self.devices)} (use predict_clips)')

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """An empty host tensor of numpy ``dtype``, pinned when the engine
        is on the card (so that its upload is one DMA)."""
        return torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype,
            pin_memory=self.device.type == 'cuda')

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        dev = host.to(self.device, non_blocking=True)
        self._sync()
        return dev

    @staticmethod
    def _byte_balanced(bounds: np.ndarray, threads: int
                       ) -> List[Tuple[int, int]]:
        """Row ranges [lo, hi) for at most ``threads`` readers, cut where
        the cumulative size ``bounds`` (n + 1 entries from 0) is closest
        to an even share."""
        n = len(bounds) - 1
        k = max(1, min(int(threads), n))
        cuts = [int(np.searchsorted(bounds, bounds[-1] * i / k))
                for i in range(k + 1)]
        cuts[0], cuts[-1] = 0, n
        cuts = sorted(set(cuts))
        return list(zip(cuts[:-1], cuts[1:]))

    @staticmethod
    def _read_shares(shares: Sequence[Tuple[int, int]], read_rows) -> None:
        """``read_rows(lo, hi)`` for each (lo, hi) share, one thread a
        share; the first exception is raised here."""
        if len(shares) == 1:
            read_rows(*shares[0])
            return
        with ThreadPoolExecutor(len(shares)) as pool:
            for f in [pool.submit(read_rows, lo, hi) for lo, hi in shares]:
                f.result()

    @torch.inference_mode()
    def _serve_resident(self, rows_of: Callable[[int, int], torch.Tensor],
                        n: int, names: List[str],
                        telemetry: Optional[dict], times: dict,
                        bytes_h2d: int
                        ) -> Tuple[List[List[dict]], List[str]]:
        """``rows_of(i0, i1)``: clips [i0, i1) on the device, as wire rows
        or decoded.  Per batch the forward and coverage normalisation,
        then one pull of the whole pass (``_pull_tracks``), the host
        decode and the XML, as ``predict_clips`` does."""
        times.update(launch_s=0.0, pull_s=0.0, decode_s=0.0)
        if not n:                  # no clips: no forward, no pull
            if telemetry is not None:
                telemetry.update(times, bytes_h2d=int(bytes_h2d),
                                 bytes_d2h=0, n_batches=0)
            return [], []
        framewise = []
        for i0 in range(0, n, self.batch_size):
            with span('serve.forward', times, 'launch_s'):
                framewise.append(self._run_covered(
                    self.model, rows_of(i0, min(n, i0 + self.batch_size)))[0])
        framewise = torch.cat(framewise)
        pulled = self._pull_tracks(framewise, times)
        per_clip = self._decode_pulled(pulled, n, names, framewise.shape[1],
                                       times)
        xmls = self._clip_xmls(per_clip, names, times)
        if telemetry is not None:
            telemetry.update(times, bytes_h2d=int(bytes_h2d),
                             bytes_d2h=int(pulled[-1]),
                             n_batches=-(-n // self.batch_size))
        return per_clip, xmls

    def predict_clips_resident(self, wavs: np.ndarray,
                               names: Optional[List[str]] = None,
                               telemetry: Optional[dict] = None
                               ) -> Tuple[List[List[dict]], List[str]]:
        """``predict_clips`` with the whole of ``wavs`` uploaded at once:
        one copy from pinned host memory, then per batch a slice on the
        device -> wire decode -> forward, then one pull of the track
        maxima and masks of the pass.  Results identical to
        ``predict_clips``.  ``telemetry``, when given a dict, gets the
        phase wall times (``read_s`` 0, ``upload_s``, ``launch_s``: the
        batches queued, ``pull_s``: until the masks are on the host,
        ``decode_s``: events and XML), ``bytes_h2d``, ``bytes_d2h`` and
        ``n_batches``.  One device.
        """
        self._single_device('predict_clips_resident')
        n = wavs.shape[0]
        if names is None:
            names = [f'clip{i}.wav' for i in range(n)]
        self._check_clip_widths(wavs)
        times = dict(read_s=0.0)
        with span('serve.upload', times, 'upload_s'):
            host = self._host_buffer(wavs.shape, wavs.dtype)
            host.numpy()[:] = wavs
            dev = self._upload(host)
        return self._serve_resident(lambda i0, i1: dev[i0:i1], n, names,
                                    telemetry, times, host.nbytes)

    def predict_files_resident(self, paths: Sequence[str], reader,
                               names: Optional[List[str]] = None,
                               upload_threads: int = 4,
                               telemetry: Optional[dict] = None,
                               max_pass_clips: Optional[int] = None
                               ) -> Tuple[List[List[dict]], List[str]]:
        """File-list variant of ``predict_clips_resident``:
        ``reader(path)`` returns the 1-D wire row of one clip (any format
        ``predict_clips`` accepts, e.g. ``audio_io.wire_reader_for``'s);
        all files must give the same width and dtype.  ``upload_threads``
        threads read their contiguous share of the files straight into
        the pinned pass buffer, which is then uploaded once.  Results
        identical to reading everything and calling ``predict_clips``.

        ``max_pass_clips`` bounds device memory: the files are served in
        passes of at most that many clips, with results identical to one
        pass; ``telemetry`` then sums over the passes and gets
        ``passes``.  ``read_s`` is the reads' wall time, ``upload_s``
        the copy's.
        """
        self._single_device('predict_files_resident')
        if not len(paths):
            raise ValueError('predict_files_resident: empty file list')
        n = len(paths)
        if names is None:
            names = [os.path.basename(p) for p in paths]
        if max_pass_clips is not None and n > int(max_pass_clips):
            step = int(max_pass_clips)
            if step < 1:
                raise ValueError(f'max_pass_clips must be >= 1, got {step}')
            events: List[List[dict]] = []
            xmls: List[str] = []
            acc: dict = {}
            for lo in range(0, n, step):
                tel = {} if telemetry is not None else None
                ev, xs = self.predict_files_resident(
                    paths[lo:lo + step], reader, names[lo:lo + step],
                    upload_threads, tel)
                events.extend(ev)
                xmls.extend(xs)
                for k, v in (tel or {}).items():
                    acc[k] = acc.get(k, 0) + v
            if telemetry is not None:
                telemetry.update(acc, passes=-(-n // step))
            return events, xmls
        times: dict = {}
        with span('serve.read', times, 'read_s'):
            first = np.asarray(reader(paths[0]))
            self._check_clip_widths(first[None])
            host = self._host_buffer((n,) + first.shape, first.dtype)
            buf = host.numpy()
            buf[0] = first

            def read_rows(lo: int, hi: int) -> None:
                for j in range(max(lo, 1), hi):
                    row = np.asarray(reader(paths[j]))
                    if row.shape != first.shape or row.dtype != first.dtype:
                        raise ValueError(
                            f'{paths[j]}: wire row {row.shape} {row.dtype}, '
                            f'the first file gave {first.shape} '
                            f'{first.dtype}')
                    buf[j] = row

            self._read_shares(self._byte_balanced(np.arange(n + 1),
                                                  upload_threads), read_rows)
        with span('serve.upload', times, 'upload_s'):
            dev = self._upload(host)
        return self._serve_resident(lambda i0, i1: dev[i0:i1], n, names,
                                    telemetry, times, host.nbytes)

    def _ragged_plan(self, payload_bytes: Sequence[int], n_threads: int):
        """Plan a ragged pass: each clip's word offset in the pool, the
        reader threads' row chunks balanced by bytes, and the byte bounds
        of the payloads in the pool."""
        pb = np.asarray(payload_bytes, np.int64)
        if (pb % 16).any():
            raise ValueError('v6 payloads are 16-byte padded')
        bounds_b = np.concatenate([[0], np.cumsum(pb)])
        return ((bounds_b[:-1] // 4).astype(np.int32),
                self._byte_balanced(bounds_b, n_threads), bounds_b)

    def predict_files_resident_ragged(
            self, paths: Sequence, reader,
            names: Optional[List[str]] = None,
            upload_threads: int = 4,
            telemetry: Optional[dict] = None,
            payload_bytes: Optional[Sequence[int]] = None
            ) -> Tuple[List[List[dict]], List[str]]:
        """Ragged-wire variant of ``predict_files_resident``:
        ``reader(path)`` returns each clip's variable-length uint8 v6
        payload (``audio_io.read_v6``'s first item).  The pass uploads
        one flat pool of exactly the true bytes plus a zero tail of
        ``_RAGGED_TAIL_WORDS`` words, and the clips' word offsets; each
        batch is decoded on the device by ``ops.wire.dequant_v6_pool``.
        Results identical to the q6 wire's (the v6 decode is
        bit-identical).  ``payload_bytes`` skips the size stat
        (``audio_io.v6_payload_bytes``) when the caller knows the sizes.
        One device.
        """
        self._single_device('predict_files_resident_ragged')
        if not len(paths):
            raise ValueError('predict_files_resident_ragged: empty file '
                             'list')
        n = len(paths)
        if names is None:
            names = [os.path.basename(p) for p in paths]
        if payload_bytes is None:
            payload_bytes = [audio_io.v6_payload_bytes(p) for p in paths]
        offsets, chunks, bounds_b = self._ragged_plan(payload_bytes,
                                                      upload_threads)
        times: dict = {}
        with span('serve.read', times, 'read_s'):
            host = self._host_buffer(
                (int(bounds_b[-1]) + 4 * self._RAGGED_TAIL_WORDS,), np.uint8)
            buf = host.numpy()
            buf[bounds_b[-1]:] = 0

            def read_rows(lo: int, hi: int) -> None:
                for j in range(lo, hi):
                    row = np.asarray(reader(paths[j]))
                    if row.dtype != np.uint8 or \
                            row.nbytes != payload_bytes[j]:
                        raise ValueError(
                            f'{paths[j]}: {row.nbytes} bytes of {row.dtype}, '
                            f'expected {payload_bytes[j]} uint8')
                    buf[bounds_b[j]:bounds_b[j + 1]] = row

            self._read_shares(chunks, read_rows)
        with span('serve.upload', times, 'upload_s'):
            pool = self._upload(host.view(torch.int32))
        offs = torch.from_numpy(offsets).to(self.device)
        samples = self.window_samples
        return self._serve_resident(
            lambda i0, i1: wire_ops.dequant_v6_pool(pool, offs[i0:i1],
                                                    samples),
            n, names, telemetry, times, host.nbytes + offsets.nbytes)

    def predict_rows_resident(self, rows_list: Sequence[np.ndarray],
                              names: Optional[List[str]] = None
                              ) -> Tuple[List[List[dict]], List[str]]:
        """In-memory ragged predict: each element of ``rows_list`` is one
        clip's variable-length uint8 v6 payload; results identical to
        the file path."""
        return self.predict_files_resident_ragged(
            list(range(len(rows_list))), lambda i: rows_list[i],
            names=names or [f'clip{i}.wav' for i in range(len(rows_list))],
            upload_threads=1,
            payload_bytes=[int(np.asarray(r).nbytes) for r in rows_list])
