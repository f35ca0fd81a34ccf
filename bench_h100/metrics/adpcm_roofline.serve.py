"""``adpcm_roofline.serve``: the ADPCM wire decode (``ops/wire.
_adpcm_decode`` -> ``csrc/adpcm_decode.cu``) against its roofline, in %:
the least time an H100 could take for one launch (its bytes: the wire
rows read once, the float32 samples written once, at
``yardstick.PEAK_HBM_BYTES``) over the kernel's mean device time a
launch in the traced segment.  The launches the trace holds must be
those the wrapper's counter ``_adpcm_decode.launches`` counted.  None
where the run served no wire or the trace holds no such kernel."""

from bench_h100 import yardstick


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve' \
            or not run.info.get('wire'):
        return None
    us, launches = run.trace.kernel_us('adpcm_decode')
    if not launches:
        return None
    counted = run.counters['_adpcm_decode.launches']
    if launches != counted:
        raise RuntimeError(f'the trace holds {launches} ADPCM launches, '
                           f'the counter {counted}')
    clips = run.info['traced_clips']
    nbytes = clips * (run.info['wire_bytes'] + 4 * run.info['clip_samples'])
    return 100.0 * nbytes / yardstick.PEAK_HBM_BYTES / (us / 1e6)
