"""``conv3x3_ms_per_clip.serve``: device ms a served clip spends in the
conv stack's eval-mode 3x3 convolutions (one launch of
``csrc/conv3x3.cu`` each, and its split-K sum where it splits), launched
under the program's ``sed::conv.3x3`` spans, in the traced segment.  None
where the segment holds no such span, as a program without the kernel
gives."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve' \
            or not spans.count(run.trace, 'conv.3x3'):
        return None
    us = run.trace.span_us('sed::conv.3x3')
    return us / 1e3 / run.info['traced_clips'] if us else None
