"""``mfu.serve``: the served clips' counted operations (``yardstick``:
the forward of each clip, log-mel included, the temporal block as its
configuration counts it) over the window, as a share
of the H100's dense bf16 peak, in %.  Host clock (the untraced window)."""

from bench_h100 import yardstick


def read(run):
    info = run.info
    if info.get('kind') != 'serve' or not info.get('clips'):
        return None
    flop = yardstick.forward_flop(info['config'], info['clip_samples'],
                                  info['model'].temporal_flop)
    return 100.0 * flop * info['clips'] / info['window_s'] \
        / yardstick.PEAK_BF16_FLOPS
