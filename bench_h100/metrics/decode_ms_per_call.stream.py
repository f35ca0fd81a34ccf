"""``decode_ms_per_call.stream``: host ms a ``feed`` or ``flush`` call
spends inside the program's ``sed::stream.decode`` span (the prefix
decode and the finality walk of ``serve/streaming.py``), over the traced
stream's calls (its ``sed::stream.feed`` and ``sed::stream.flush``
spans)."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'stream':
        return None
    calls = spans.count(run.trace, 'stream.feed', 'stream.flush')
    us = spans.host_us(run.trace, 'stream.decode')
    return None if not calls or us is None else us / 1e3 / calls
