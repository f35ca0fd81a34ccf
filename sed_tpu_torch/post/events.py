"""Framewise probabilities -> event lists / submission files.

Mirrors ``utils/utilities.py:82-291``.  The batch decoder short-circuits
tracks that never cross the high threshold (a vectorized max over time),
which is what keeps host-side decoding off the critical path at
1000 clips/s — most of the 25 class tracks of a clip are silent.

A copy of ``sed_tpu/post/events.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from sed_tpu_torch import config as cfg
from sed_tpu_torch.config import SedParams
from sed_tpu_torch.post import vad


def _as_params_dict(sed_params, classes_num: int) -> dict:
    if isinstance(sed_params, SedParams):
        return sed_params.per_class(classes_num)
    return SedParams.from_dict(sed_params).per_class(classes_num)


def frame_prediction_to_event_prediction(output_dict: dict, sed_params,
                                         frames_per_second: int,
                                         labels: Sequence[str] = cfg.LABELS
                                         ) -> List[dict]:
    """Decode a batch of clips into an event list.

    Matches ``utils/utilities.py:82-153``: every clip x class track is
    decoded with dual-threshold activity detection (the audio-tagging
    gate is commented out in the reference too) and pairs become events
    with onset/offset in seconds at ``frames_per_second``.
    """
    framewise = np.asarray(output_dict['framewise_output'])
    names = output_dict['audio_name']
    return decode_batch(framewise, list(names), sed_params,
                        frames_per_second, labels)


def frame_prediction_to_event_prediction_v2(framewise_output, audio_name: str,
                                            sed_params,
                                            frames_per_second: int,
                                            labels: Sequence[str] = cfg.LABELS
                                            ) -> List[dict]:
    """Single-file variant (``utils/utilities.py:155-214``)."""
    framewise = np.asarray(framewise_output)
    names = [audio_name] * framewise.shape[0]
    return decode_batch(framewise, names, sed_params, frames_per_second,
                        labels)


def decode_batch(framewise: np.ndarray, names: List[str], sed_params,
                 frames_per_second: int,
                 labels: Sequence[str] = cfg.LABELS) -> List[dict]:
    """Vectorized-gated event decode for (N, T, C) probabilities.

    Only tracks that cross their high threshold are decoded; those go
    through the native C++ batch decoder when available (this is the hot
    loop of both the evaluator and the threshold optimizer, which re-runs
    it hundreds of times per epoch — ``optimize_thresholds.py:73-101``).
    """
    (audios_num, t_frames, classes_num) = framewise.shape
    p = _as_params_dict(sed_params, classes_num)
    high = np.asarray(p['sed_high_threshold'], np.float64)
    low = np.asarray(p['sed_low_threshold'], np.float64)

    # Skip silent tracks without touching Python-level decode.
    track_max = framewise.max(axis=1)                  # (N, C)
    act_n, act_c = np.nonzero(track_max > high[None, :])

    event_list: List[dict] = []
    fps = float(frames_per_second)
    if act_n.size == 0:
        return event_list

    from sed_tpu_torch.native.vad_native import (native_available,
                                                 decode_packed_tracks)
    if native_available():
        tracks = framewise[act_n, :, act_c]            # (K, T)
        high_bits = tracks > high[act_c][:, None]
        low_bits = tracks >= low[act_c][:, None]
        all_pairs = decode_packed_tracks(
            np.packbits(high_bits, axis=1), np.packbits(low_bits, axis=1),
            t_frames,
            np.asarray(p['n_smooth'], np.int32)[act_c],
            np.asarray(p['n_salt'], np.int32)[act_c])
    else:
        all_pairs = [
            vad.activity_detection(
                x=framewise[n, :, k],
                thres=p['sed_high_threshold'][k],
                low_thres=p['sed_low_threshold'][k],
                n_smooth=p['n_smooth'][k],
                n_salt=p['n_salt'][k])
            for n, k in zip(act_n, act_c)
        ]
    for (n, k), pairs in zip(zip(act_n, act_c), all_pairs):
        for bgn, fin in pairs:
            event_list.append({
                'filename': names[n],
                'onset': bgn / fps,
                'offset': fin / fps,
                'event_label': labels[k]})
    return event_list


def frame_binary_prediction_to_event_prediction(
        framewise_output, overlap_value, sample_duration, audio_name: str,
        sed_params, frames_per_second: int = 100,
        labels: Sequence[str] = cfg.LABELS) -> List[dict]:
    """Voting-pipeline decode (``utils/utilities.py:216-276``)."""
    framewise = np.asarray(framewise_output)
    (audios_num, _, classes_num) = framewise.shape
    p = _as_params_dict(sed_params, classes_num)
    fps = float(frames_per_second)

    event_list: List[dict] = []
    for n in range(audios_num):
        for k in range(classes_num):
            pairs = vad.activity_detection_binary(
                x=framewise[n, :, k],
                overlap_value=overlap_value,
                sample_duration=sample_duration,
                thres=p['sed_high_threshold'][k],
                low_thres=p['sed_low_threshold'][k],
                n_smooth=p['n_smooth'][k],
                n_salt=p['n_salt'][k])
            for bgn, fin in pairs:
                event_list.append({
                    'filename': audio_name,
                    'onset': bgn / fps,
                    'offset': fin / fps,
                    'event_label': labels[k]})
    return event_list


def write_submission(event_list: List[dict], submission_path: str) -> None:
    """TSV ``filename\\tonset\\toffset\\tlabel`` (``utils/utilities.py:278-291``)."""
    with open(submission_path, 'w') as f:
        for event in event_list:
            f.write('{}\t{}\t{}\t{}\n'.format(
                event['filename'], event['onset'], event['offset'],
                event['event_label']))
