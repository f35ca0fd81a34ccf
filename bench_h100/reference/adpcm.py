"""Plain IMA ADPCM 4-bit decoder (IMA/DVI-4, the WAVE_FORMAT_IMA_ADPCM
block layout), for the reference side of the wire cells: host numpy,
written from the step and index tables, nothing of the program.

A row is blocks of ``BLOCK_ALIGN`` bytes and one trailing pad byte.  A
block is a 4-byte header (int16 little-endian predictor, which is the
block's first sample; uint8 step index; one reserved byte) and then
``BLOCK_ALIGN - 4`` bytes of 4-bit codes, the low nibble first, one code
a further sample.  A code's bit 3 is the sign; bits 2, 1, 0 add step,
step / 2 and step / 4 to step / 8 (each a truncating shift); the
predictor saturates at int16; the index moves by the index table and
stays in [0, 88].  Samples come out as int16 / 32768.
"""

from __future__ import annotations

import numpy as np

BLOCK_ALIGN = 256

STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767], np.int64)
INDEX_MOVES = np.array([-1, -1, -1, -1, 2, 4, 6, 8] * 2, np.int64)


def decode(rows: np.ndarray, samples: int) -> np.ndarray:
    """(N, width) uint8 rows -> (N, samples) float32 in [-1, 1)."""
    n = rows.shape[0]
    blocks = (rows.shape[1] - 1) // BLOCK_ALIGN
    b = rows[:, :blocks * BLOCK_ALIGN].reshape(n * blocks, BLOCK_ALIGN) \
        .astype(np.int64)
    pred = b[:, 0] | (b[:, 1] << 8)
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = np.clip(b[:, 2], 0, 88)
    codes = np.stack([b[:, 4:] & 15, b[:, 4:] >> 4], axis=2) \
        .reshape(len(b), -1)
    out = np.empty((len(b), codes.shape[1] + 1), np.int64)
    out[:, 0] = pred
    for t in range(codes.shape[1]):
        code = codes[:, t]
        step = STEPS[index]
        diff = (step >> 3) + np.where(code & 4, step, 0) \
            + np.where(code & 2, step >> 1, 0) \
            + np.where(code & 1, step >> 2, 0)
        pred = np.clip(np.where(code & 8, pred - diff, pred + diff),
                       -32768, 32767)
        out[:, t + 1] = pred
        index = np.clip(index + INDEX_MOVES[code], 0, 88)
    return (out.reshape(n, -1)[:, :samples] / 32768.0).astype(np.float32)
