"""``epilogue_ms_per_clip.serve``: device ms a served clip spends in the
conv stack's eval-mode epilogues (BatchNorm, ReLU and the 2x2 average
pool after each convolution, one launch of ``csrc/conv_epilogue.cu``
each), launched under the program's ``sed::conv.epilogue`` spans, in the
traced segment.  None where the segment holds no such span, as a program
without the kernel gives."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve' \
            or not spans.count(run.trace, 'conv.epilogue'):
        return None
    us = run.trace.span_us('sed::conv.epilogue')
    return us / 1e3 / run.info['traced_clips'] if us else None
