"""``panns_head_ms_per_clip.serve``: device ms a served clip spends in
PANNs CNN14's head after the conv stack (the 3-wide max + average
smoothing, fc1, the attention head, the x32 interpolation and the pad),
launched under the program's ``sed::panns.head`` spans, in the traced
segment.  None where the segment holds no such span, as another model or
a program without the span gives."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve' \
            or not spans.count(run.trace, 'panns.head'):
        return None
    us = run.trace.span_us('sed::panns.head')
    return us / 1e3 / run.info['traced_clips'] if us else None
