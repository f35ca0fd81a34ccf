"""``device_idle.eval``: the share of the traced segment, in %, in which no
device operation ran on any stream: 1 - (union of the busy intervals of
every kernel, copy and set) / segment.  What holds the card back in the
windowed evaluation path: the window slicing, the overlap-add's launches,
the pulls, the host decode."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'eval':
        return None
    share = run.trace.idle_share()
    return None if share is None else 100.0 * share
