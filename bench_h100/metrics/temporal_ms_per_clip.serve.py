"""``temporal_ms_per_clip.serve``: device ms a served clip spends in the
temporal block (the BiGRU or the self-attention block of
``models/blocks``), launched under the benchmark's ``bench::temporal``
span around that module's forward, in the traced segment."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us = run.trace.span_us('bench::temporal')
    return us / 1e3 / run.info['traced_clips'] if us else None
