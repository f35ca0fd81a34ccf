"""``decode_idle_ms_per_clip.serve``: device-idle ms a served clip spends
while the host is inside the program's ``sed::serve.decode`` or
``sed::serve.xml`` spans (the host event decode and the XML of
``serve/engine.py``), in the traced segment."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us = spans.idle_us(run.trace, 'serve.decode', 'serve.xml')
    return None if us is None else us / 1e3 / run.info['traced_clips']
