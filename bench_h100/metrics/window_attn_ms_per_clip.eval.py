"""``window_attn_ms_per_clip.eval``: device ms an evaluated clip spends in
HTS-AT's window attention (``models/htsat.SwinBlock``'s attention
sub-block: the roll, the window partition, qkv, the scores, the
relative-position bias and the shift mask, softmax, the weighted values,
the projection, the reverse and the roll back), launched under the
program's ``sed::htsat.attn`` spans, in the traced segment.  None where
the segment holds no such span, as another model or a program without
the span gives."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'eval' \
            or not spans.count(run.trace, 'htsat.attn'):
        return None
    us = run.trace.span_us('sed::htsat.attn')
    return us / 1e3 / run.info['traced_clips'] if us else None
