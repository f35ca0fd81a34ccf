"""``decode_redo.stream``: frames the stream's event decoder was handed
per frame streamed, over the run: the program's counters
``StreamingSed.frames_decoded`` over ``StreamingSed.frames_streamed``
(``serve/streaming.py``).  Each feed re-decodes the whole final prefix,
so a 120 s stream in 1 s chunks reads ~57.5; a decode of the new tail
alone would read ~1."""

import sys


def read(run):
    if run.info.get('kind') != 'stream':
        return None
    module = sys.modules.get('sed_tpu_torch.serve.streaming')
    live = getattr(module, 'StreamingSed', None)
    streamed = getattr(live, 'frames_streamed', 0)
    return live.frames_decoded / streamed if streamed else None
