"""``swin_idle_ms_per_clip.eval``: device-idle ms an evaluated clip spends
while the host is inside the program's ``sed::htsat.encoder`` span
(``models/htsat.SwinEncoder``: ~25 launches a block, 12 blocks), in the
traced segment: what the encoder's launches cost where the device is not
ahead of the host.  None where the segment holds no such span."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'eval':
        return None
    us = spans.idle_us(run.trace, 'htsat.encoder')
    return None if us is None else us / 1e3 / run.info['traced_clips']
