"""``batch_wait_ms_per_step.train``: host ms a training step spends
inside the program's ``sed::train.batch_wait`` span (the step waiting on
``train/prefetch.device_prefetch``'s queue for its batch), over the
traced steps."""

from bench_h100 import spans


def read(run):
    if run.trace is None or run.info.get('kind') != 'train':
        return None
    us = spans.host_us(run.trace, 'train.batch_wait')
    steps = run.info['traced_clips'] // run.info['clips_per_step']
    return None if us is None else us / 1e3 / steps
