"""``batchnorm_ms_per_clip.train``: device ms a training clip spends in
BatchNorm in training mode, forward and backward, with the running
statistics' ``var_mean`` (``models/blocks.BatchNorm``; the op group of
``chip_smoke.TRAIN_OP_GROUPS``), in the traced steps."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'train':
        return None
    us = run.trace.op_us(('aten::cudnn_batch_norm',
                          'aten::cudnn_batch_norm_backward',
                          'aten::var_mean'))
    return us / 1e3 / run.info['traced_clips'] if us else None
