"""Global configuration for sed_tpu_torch (a copy of ``sed_tpu/config.py``).

The reference scatters one module of constants (``utils/config.py``) plus an
audio-quality triad duplicated across seven call sites (e.g.
``pytorch/main_strong.py:88-111``, ``pytorch/predict.py:186-203``).  Here the
whole thing is a frozen dataclass keyed by quality so every entry point reads
one source of truth.

Reference parity: class ids/labels follow ``utils/config.py:22-26``; the
8k/16k/32k hyper-parameter triad follows ``pytorch/main_strong.py:88-111``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Class inventory (reference utils/config.py:22-26)
# ---------------------------------------------------------------------------

IDS: Tuple[str, ...] = (
    '/m/028ght', '/m/0lyf6', '/m/07rkbfh', '/m/053hz1', '/m/0ytgt',
    '/m/0l15bq', '/m/01h8n0', '/m/01b_21', '/m/03qtwd', '/m/0463cq4',
    '/m/02zsn', '/m/01j3sz', '/m/05zppz', '/m/06h7j', '/m/03qc9zr',
    '/m/07p6fty', '/m/01hsr_', '/m/07pbtc8', '/m/02rtxlg', '/m/05x_td',
    '/m/02mfyn', '/m/03j1ly', '/m/014zdl', '/m/032s66', '/m/03kmc9',
)

LABELS: Tuple[str, ...] = (
    'Applause', 'Breathing', 'Chatter', 'Cheering',
    'Child_speech_kid_speaking', 'Clapping', 'Conversation', 'Cough',
    'Crowd', 'Crying_sobbing', 'Female_speech_woman_speaking', 'Laughter',
    'Male_speech_man_speaking', 'Run', 'Screaming', 'Shout', 'Sneeze',
    'Walk_footsteps', 'Whispering', 'Air_horn_truck_horn', 'Car_alarm',
    'Emergency_vehicle', 'Explosion', 'Gunshot_gunfire', 'Siren',
)

CLASSES_NUM: int = len(LABELS)
LB_TO_IDX: Dict[str, int] = {lb: i for i, lb in enumerate(LABELS)}
IDX_TO_LB: Dict[int, str] = {i: lb for i, lb in enumerate(LABELS)}

# Speech-like classes eligible for ASR transcription
# (reference pytorch/predict.py:453).
SPEECH_LABELS: Tuple[str, ...] = (
    'Child_speech_kid_speaking', 'Conversation',
    'Female_speech_woman_speaking', 'Male_speech_man_speaking',
)

AUDIO_DURATION: int = 10  # seconds per training clip (utils/config.py:2)


# ---------------------------------------------------------------------------
# Audio-quality triad
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """DSP frontend hyper-parameters for one audio quality.

    All three qualities yield 100 frames/second and 1001 STFT frames per
    10 s clip (center-padded), which downstream post-processing relies on
    (reference ``utils/utilities.py:406``).
    """

    name: str
    sample_rate: int
    window_size: int
    hop_size: int
    mel_bins: int = 64
    fmin: int = 50
    fmax: int = 14000
    window: str = 'hann'
    pad_mode: str = 'reflect'
    center: bool = True
    ref: float = 1.0
    amin: float = 1e-10
    top_db: float | None = None

    @property
    def frames_per_second(self) -> int:
        return self.sample_rate // self.hop_size

    @property
    def audio_samples(self) -> int:
        return self.sample_rate * AUDIO_DURATION

    @property
    def clip_frames(self) -> int:
        """STFT frames for a 10 s clip with center padding (= 1001)."""
        return self.audio_samples // self.hop_size + 1

    @property
    def freq_bins(self) -> int:
        return self.window_size // 2 + 1


# Quality triad — values from reference pytorch/main_strong.py:88-111.
AUDIO_8K = AudioConfig(name='8k', sample_rate=8000, window_size=256,
                       hop_size=80, fmin=12, fmax=3500)
AUDIO_16K = AudioConfig(name='16k', sample_rate=16000, window_size=512,
                        hop_size=160, fmin=25, fmax=7000)
AUDIO_32K = AudioConfig(name='32k', sample_rate=32000, window_size=1024,
                        hop_size=320, fmin=50, fmax=14000)

QUALITY: Dict[str, AudioConfig] = {
    '8k': AUDIO_8K,
    '16k': AUDIO_16K,
    '32k': AUDIO_32K,
}


def get_audio_config(audio_8k: bool = False, audio_16k: bool = False) -> AudioConfig:
    """Resolve the triad exactly like the reference CLI flags
    (``--audio_8k`` / ``--audio_16k`` / default 32k)."""
    if audio_8k:
        return AUDIO_8K
    if audio_16k:
        return AUDIO_16K
    return AUDIO_32K


# ---------------------------------------------------------------------------
# SED post-processing parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SedParams:
    """Dual-threshold event decoding parameters.

    Scalars broadcast to per-class lists exactly like the reference
    (``utils/utilities.py:104-116``).  Defaults: evaluation path uses
    {.5/.5/.2/10/10} (``pytorch/evaluate.py:45-50``); the predict path uses
    {.099/.5/.3/10/10} (``pytorch/predict.py:253-257``).
    """

    audio_tagging_threshold: tuple | float = 0.5
    sed_high_threshold: tuple | float = 0.5
    sed_low_threshold: tuple | float = 0.2
    n_smooth: tuple | int = 10
    n_salt: tuple | int = 10

    def per_class(self, classes_num: int = CLASSES_NUM) -> dict:
        """Expand scalars into per-class lists."""
        def _lst(x):
            if isinstance(x, (list, tuple)):
                assert len(x) == classes_num
                return list(x)
            return [x] * classes_num
        return {
            'audio_tagging_threshold': _lst(self.audio_tagging_threshold),
            'sed_high_threshold': _lst(self.sed_high_threshold),
            'sed_low_threshold': _lst(self.sed_low_threshold),
            'n_smooth': _lst(self.n_smooth),
            'n_salt': _lst(self.n_salt),
        }

    @staticmethod
    def from_dict(d: dict) -> 'SedParams':
        def _tup(x):
            return tuple(x) if isinstance(x, (list, tuple)) else x
        return SedParams(
            audio_tagging_threshold=_tup(d['audio_tagging_threshold']),
            sed_high_threshold=_tup(d['sed_high_threshold']),
            sed_low_threshold=_tup(d['sed_low_threshold']),
            n_smooth=_tup(d['n_smooth']),
            n_salt=_tup(d['n_salt']),
        )


EVAL_SED_PARAMS = SedParams(0.5, 0.5, 0.2, 10, 10)
PREDICT_SED_PARAMS = SedParams(0.099, 0.5, 0.3, 10, 10)
