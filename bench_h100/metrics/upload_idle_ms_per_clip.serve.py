"""``upload_idle_ms_per_clip.serve``: device-idle ms a served clip spends
while the host is inside the program's ``sed::serve.upload`` span (host
rows to the card: the pageable copy of ``serve/engine.py``), in the
traced segment."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us = spans.idle_us(run.trace, 'serve.upload')
    return None if us is None else us / 1e3 / run.info['traced_clips']
