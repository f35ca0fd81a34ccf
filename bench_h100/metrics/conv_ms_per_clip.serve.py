"""``conv_ms_per_clip.serve``: device ms a served clip spends in the
conv stack's convolutions (``aten::cudnn_convolution``'s kernels, as
``chip_smoke.profile_by_group`` groups them), in the traced segment."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us = run.trace.op_us(('aten::cudnn_convolution',))
    return us / 1e3 / run.info['traced_clips'] if us else None
