"""``mhsa_ms_per_clip.serve``: device ms a served clip spends in the
Conformer's relative-position self-attention (``models/encoders.
RelMultiHeadAttn``: LayerNorm, the shared QKV and relative projections,
the content and position scores, the relative shift, softmax, the
weighted values and the output projection), launched under the
program's ``sed::conformer.mhsa`` spans, in the traced segment."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve' \
            or not spans.count(run.trace, 'conformer.mhsa'):
        return None
    us = run.trace.span_us('sed::conformer.mhsa')
    return us / 1e3 / run.info['traced_clips'] if us else None
