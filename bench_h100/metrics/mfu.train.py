"""``mfu.train``: the train steps' counted operations (``yardstick``:
log-mel of every clip, 3x the forward of the rows mixup leaves) over the
window, as a share of the H100's dense bf16 peak, in %.  Host clock (the
untraced window)."""

from bench_h100 import yardstick


def read(run):
    info = run.info
    if info.get('kind') != 'train' or not info.get('steps'):
        return None
    flop = yardstick.train_step_flop(info['config'], info['clip_samples'],
                                     info['clips_per_step'],
                                     info['mixed_rows_per_step'],
                                     info['model'].temporal_flop)
    return 100.0 * flop * info['steps'] / info['window_s'] \
        / yardstick.PEAK_BF16_FLOPS
