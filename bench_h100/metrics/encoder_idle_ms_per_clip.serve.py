"""``encoder_idle_ms_per_clip.serve``: device-idle ms a served clip spends
while the host is inside the program's ``sed::conformer.encoder`` span
(``models/encoders.ConformerEncoder``: ~130 small launches a forward),
in the traced segment: what the encoder's launches cost where the device
is not ahead of the host."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us = spans.idle_us(run.trace, 'conformer.encoder')
    return None if us is None else us / 1e3 / run.info['traced_clips']
