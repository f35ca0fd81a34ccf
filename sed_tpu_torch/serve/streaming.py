"""Online (streaming) sound event detection (counterpart of
``sed_tpu/serve/streaming.py``).

A capability beyond the reference (its serving is strictly batch:
``pytorch/predict.py`` loads whole files): feed audio in arbitrary-size
chunks as it arrives — a live microphone, an RTP leg, a rolling file —
and receive events incrementally, each emitted as soon as it is
PROVABLY final (no future audio can change it), with the complete
stream result at ``flush()`` exactly equal to the offline pipeline
(``SedInferenceEngine.predict_waveform`` on the concatenated audio; the
equality is pinned by tests/test_torch_streaming.py across random
chunkings).

How finality is decided, per class:

* window grid: the reference's overlapped 5 s windows advancing 1 s
  (``predict.py:334-338``); a window runs through the engine's
  ``infer_framewise`` on the engine's device as soon as its last sample
  arrives (multiple ready windows batch into one forward).
* normalization: ``avg_merge``'s coverage divisor depends on the FINAL
  stream length through its end-branch (``utils/utilities.py:425-446``),
  so only frames more than one window-minus-hop behind the last
  processed window ("norm-final" frames) have their offline divisor.
* event stability: future audio reaches backward only through (a) the
  low-threshold extension across ``x >= low`` frames and (b) gap
  smoothing across ``<= n_smooth`` below-low frames.  Walking backward
  from the norm-final boundary, frames connected to it through
  below-low gaps of ``<= n_smooth + margin`` are "unstable"; an event
  separated from the unstable region by a longer silent gap can never
  be extended, merged, or revived by future audio.  The margin absorbs
  the decoder's +-1 boundary quirks (``utils/vad.py:118-121``) — a
  larger margin only DELAYS emission, never changes what is emitted
  overall.

Memory: O(stream length) framewise sums (25 floats per 10 ms), not
O(windows x window length) — windows are overlap-added incrementally.

Cost: each feed that finalises frames decodes the whole norm-final
prefix again.  Two process-wide counters measure that waste:
``StreamingSed.frames_decoded`` (every frame handed to the event decoder)
over ``StreamingSed.frames_streamed`` (the frames of every flushed
stream's merged output).  ``feed`` and ``flush`` run under the
``sed::stream.*`` spans of ``utils/profiling.span``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from sed_tpu_torch.post import events as post_events
from sed_tpu_torch.post import merge as post_merge
from sed_tpu_torch.post.events import _as_params_dict
from sed_tpu_torch.serve.engine import window_starts
from sed_tpu_torch.utils.profiling import span

#: extra below-low frames (beyond n_smooth) required to declare an event
#: out of reach of future audio — covers the reference decoder's +-1
#: pair-boundary quirks and its extra gap<=1 smoothing pass
_FINALITY_MARGIN = 2


def _unstable_start(track: np.ndarray, low: float, n_gap: int) -> int:
    """First frame index still connected to the stream boundary.

    Connected = reachable from the end of ``track`` without crossing a
    run of more than ``n_gap`` consecutive frames with ``x < low``.
    """
    below = track < low
    g = 0
    for i in range(len(track) - 1, -1, -1):
        if below[i]:
            g += 1
            if g > n_gap:
                return i + g
        else:
            g = 0
    return 0


class StreamingSed:
    """Incremental wrapper over a ``SedInferenceEngine``.

    ``feed(samples)`` ingests a float32 chunk (at ``cfg.sample_rate``)
    and returns the newly finalized events; ``flush()`` ends the stream
    and returns every remaining event.  The concatenation of all
    returned events equals ``engine.predict_waveform`` on the full
    audio (up to ordering — streaming emits in finalization order).
    It runs on one device: an engine over several raises ValueError.
    """

    #: frames handed to the event decoder, over every stream (only grows)
    frames_decoded = 0
    #: frames of every flushed stream's merged output (only grows)
    frames_streamed = 0

    def __init__(self, engine, audio_name: str = 'stream'):
        assert engine.overlap, (
            'StreamingSed needs the overlapped window grid '
            '(engine overlap=True, the reference serving config)')
        if len(getattr(engine, 'devices', ())) > 1:
            raise ValueError(f'StreamingSed runs on one device; the engine '
                             f'serves on {len(engine.devices)}')
        self.engine = engine
        self.audio_name = audio_name
        self.sr = engine.cfg.sample_rate
        self.fps = engine.cfg.frames_per_second
        self.sample_duration = engine.sample_duration
        self.window_samples = engine.window_samples
        self._chunks: List[np.ndarray] = []
        self._base = 0                       # samples dropped from front
        self._total = 0                      # stream samples seen so far
        self._next_start = 0                 # next window start (seconds)
        self._sums: Optional[np.ndarray] = None   # (1, T, C) overlap-add
        self._win_frames: Optional[int] = None
        self._emitted: set = set()
        self._finished = False
        p = _as_params_dict(engine.sed_params,
                            len(engine.labels))
        self._low = np.asarray(p['sed_low_threshold'], np.float64)
        self._n_smooth = np.asarray(p['n_smooth'], np.int64)
        self._lb_to_idx = {lb: i for i, lb in enumerate(engine.labels)}

    # ------------------------------------------------------------------

    def _audio_slice(self, start_sample: int, length: int) -> np.ndarray:
        """Gather [start_sample, start_sample+length) across the
        retained chunks (absolute stream positions)."""
        assert start_sample >= self._base, (
            'window audio was already discarded')
        out = np.zeros(length, np.float32)
        pos = self._base
        for c in self._chunks:
            nxt = pos + len(c)
            lo = max(start_sample, pos)
            hi = min(start_sample + length, nxt)
            if lo < hi:
                out[lo - start_sample:hi - start_sample] = \
                    c[lo - pos:hi - pos]
            pos = nxt
            if pos >= start_sample + length:
                break
        return out

    def _drop_consumed_audio(self) -> None:
        """Raw audio before the next window's start is never read again
        — keep memory O(window), not O(stream)."""
        keep_from = self._next_start * self.sr
        pos = self._base
        while self._chunks and pos + len(self._chunks[0]) <= keep_from:
            pos += len(self._chunks.pop(0))
        self._base = pos

    def _process_ready(self) -> None:
        starts = []
        while (self._next_start + self.sample_duration) * self.sr \
                <= self._total:
            starts.append(self._next_start)
            self._next_start += 1
        if not starts:
            return
        self._forward(starts)
        self._drop_consumed_audio()

    def _forward(self, starts: List[int]) -> None:
        """The windows at ``starts`` (seconds): gathered, run through
        ``infer_framewise`` and overlap-added (the ``sed::stream.forward``
        span)."""
        with span('stream.forward'):
            windows = np.stack([
                self._audio_slice(int(s * self.sr), self.window_samples)
                for s in starts])
            framewise, _ = self.engine.infer_framewise(windows)
            self._add_windows(framewise, starts)

    def _add_windows(self, framewise: np.ndarray, starts: List[int]):
        t_win = framewise.shape[1]
        if self._win_frames is None:
            self._win_frames = t_win
        step = int(self.fps * self.engine.overlap_value)
        need = int(starts[-1] * step) + t_win
        c = framewise.shape[2]
        if self._sums is None:
            self._sums = np.zeros((1, need, c), framewise.dtype)
        elif self._sums.shape[1] < need:
            grown = np.zeros((1, need, c), self._sums.dtype)
            grown[:, :self._sums.shape[1]] = self._sums
            self._sums = grown
        for w, s in zip(framewise, starts):
            off = int(s * step)
            self._sums[0, off:off + t_win] += w

    # ------------------------------------------------------------------

    def _norm_final_frames(self) -> int:
        """Frames whose avg_merge divisor can no longer change."""
        if self._next_start == 0 or self._win_frames is None:
            return 0
        step = int(self.fps * self.engine.overlap_value)
        t_total = self._win_frames + (self._next_start - 1) * step
        interval = self.sample_duration * self.fps - step
        return max(0, t_total - interval)

    def _decode_prefix(self, n_frames: int) -> List[dict]:
        step = int(self.fps * self.engine.overlap_value)
        t_total = self._win_frames + (self._next_start - 1) * step
        div = post_merge.coverage_counts(
            t_total, self.sample_duration, self.engine.overlap_value)
        probs = self._sums[:, :n_frames] / div[:n_frames][None, :, None]
        StreamingSed.frames_decoded += probs.shape[1]
        return post_events.frame_prediction_to_event_prediction_v2(
            probs, self.audio_name, self.engine.sed_params, self.fps,
            self.engine.labels), probs

    def _finalized(self) -> List[dict]:
        """The events of the norm-final prefix that no later audio can
        change and that were not emitted yet (the ``sed::stream.decode``
        span)."""
        b0 = self._norm_final_frames()
        if b0 <= 0:
            return []
        with span('stream.decode'):
            evs, probs = self._decode_prefix(b0)
            out = []
            unstable = {}
            for e in evs:
                k = self._lb_to_idx[e['event_label']]
                fin = int(round(e['offset'] * self.fps))
                if k not in unstable:
                    unstable[k] = _unstable_start(
                        probs[0, :, k], self._low[k],
                        int(self._n_smooth[k]) + _FINALITY_MARGIN)
                if fin + int(self._n_smooth[k]) + _FINALITY_MARGIN \
                        >= unstable[k]:
                    continue
                key = (e['event_label'], round(e['onset'], 4),
                       round(e['offset'], 4))
                if key in self._emitted:
                    continue
                self._emitted.add(key)
                out.append(e)
            return out

    # ------------------------------------------------------------------

    def feed(self, samples: np.ndarray) -> List[dict]:
        """Ingest a chunk; return events finalized by it."""
        assert not self._finished, 'stream already flushed'
        with span('stream.feed'):
            samples = np.asarray(samples, np.float32).reshape(-1)
            if samples.size:
                self._chunks.append(samples)
                self._total += samples.size
            self._process_ready()
            return self._finalized()

    def flush(self) -> List[dict]:
        """End of stream: process the tail and return every event not
        yet emitted.  feed()+flush() output == the offline pipeline."""
        assert not self._finished, 'stream already flushed'
        self._finished = True
        with span('stream.flush'):
            self._process_ready()
            duration = self._total / float(self.sr)
            # the offline grid always contains start 0, padded if the
            # whole stream is shorter than one window
            # (engine.predict_waveform / predict.py:297-305)
            starts = window_starts(duration, self.sample_duration, True)
            missing = [int(s) for s in starts if s >= self._next_start]
            if missing:
                self._forward(missing)
                self._next_start = missing[-1] + 1
            if self._sums is None:
                return []
            with span('stream.decode'):
                probs = post_merge.avg_merge(
                    self._sums, self.sample_duration,
                    self.engine.overlap_value)
                StreamingSed.frames_decoded += probs.shape[1]
                StreamingSed.frames_streamed += probs.shape[1]
                evs = post_events.frame_prediction_to_event_prediction_v2(
                    probs, self.audio_name, self.engine.sed_params, self.fps,
                    self.engine.labels)
                out = []
                for e in evs:
                    key = (e['event_label'], round(e['onset'], 4),
                           round(e['offset'], 4))
                    if key not in self._emitted:
                        self._emitted.add(key)
                        out.append(e)
                return out
