"""int16 <-> float32 conversion of packed HDF5 waveforms (a copy of
``sed_tpu/data/hdf5_pack.py:int16_to_float32``)."""

from __future__ import annotations

import numpy as np


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    return (x / 32767.0).astype(np.float32)
