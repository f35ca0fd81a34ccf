"""``device_idle.stream``: the share of the traced segment, in %, in which no
device operation ran on any stream: 1 - (union of the busy intervals of
every kernel, copy and set) / segment.  What holds the card back in
streaming: the host merge, the prefix decode and the batch-1 launches."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'stream':
        return None
    share = run.trace.idle_share()
    return None if share is None else 100.0 * share
