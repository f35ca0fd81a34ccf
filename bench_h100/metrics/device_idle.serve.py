"""``device_idle.serve``: the share of the traced segment, in %, in which no
device operation ran on any stream: 1 - (union of the busy intervals of
every kernel, copy and set) / segment.  What holds the card back in
serving: the engine's host side (upload, track-max and mask pulls, native decode, XML) and its launches."""


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    share = run.trace.idle_share()
    return None if share is None else 100.0 * share
