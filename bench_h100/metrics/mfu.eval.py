"""``mfu.eval``: the counted operations of the windows the evaluation
path served (``yardstick``: the forward of each window, log-mel
included, the temporal block as its configuration counts it) over the
window, as a share of the H100's dense bf16 peak, in %.  Host clock (the
untraced window).  The overlap-add and decode are not counted."""

from bench_h100 import yardstick


def read(run):
    info = run.info
    if info.get('kind') != 'eval' or not info.get('windows'):
        return None
    flop = yardstick.forward_flop(info['config'], info['window_samples'],
                                  info['model'].temporal_flop)
    return 100.0 * flop * info['windows'] / info['window_s'] \
        / yardstick.PEAK_BF16_FLOPS
