"""``conv_ms_per_clip.train``: device ms a training clip (weak or strong)
spends in the convolutions, forward and backward
(``aten::cudnn_convolution``, ``aten::convolution_backward``), in the
traced steps."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'train':
        return None
    us = run.trace.op_us(('aten::cudnn_convolution',
                          'aten::convolution_backward'))
    return us / 1e3 / run.info['traced_clips'] if us else None
