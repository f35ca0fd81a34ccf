"""``logmel_roofline``: the log-mel kernel (``ops/logmel_kernel.py`` ->
``csrc/logmel.cu``) against its roofline, in %: the least time the H100
could take for one launch's batch (``yardstick.logmel_bound_s``, a copy
of ``chip_smoke.bound_ms``) over the kernel's mean device time a launch
in the traced segment.  The launches the trace holds must be those the
wrapper's counter ``fused_logmel.launches`` counted."""

from bench_h100 import yardstick


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    us, launches = run.trace.kernel_us('logmel')
    if not launches:
        return None
    counted = run.counters['fused_logmel.launches']
    if launches != counted:
        raise RuntimeError(f'the trace holds {launches} log-mel launches, '
                           f'the counter {counted}')
    bound_s, _ = yardstick.logmel_bound_s(
        run.info['config'], run.info['batch_size'], run.info['clip_samples'])
    return 100.0 * bound_s / (us / launches / 1e6)
