"""Device-side dequantization of the audio wire (counterpart of
``sed_tpu/ops/wire.py:dequant_wire``).

Ported so far: float32 passthrough and int16 PCM (``x / 32767``, the
serving and training default).  The uint8 wires (mu-law, qN, ADPCM, v6)
come with ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import torch


def dequant_wire(wav: torch.Tensor) -> torch.Tensor:
    """(B, W) wire buffer -> (B, samples) float32 on the same device."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) / 32767.0
    if wav.dtype == torch.float32:
        return wav
    if wav.dtype == torch.uint8:
        raise NotImplementedError(
            'uint8 wires (mu-law, qN, ADPCM, v6) are not ported yet: '
            'ROADMAP queue 1 item 7, "Remaining wire decoders"')
    raise ValueError(f'unsupported wire dtype {wav.dtype}')
