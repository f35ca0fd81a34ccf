"""Gammatonegram rendering with an ERB-scaled frequency axis (a copy of
``sed_tpu/dsp/plot.py``).

Equivalent of the vendored toolkit's plotting module
(``utils/gammatone/plot.py``): render a waveform's gammatonegram with
correctly-labelled ERB-spaced ticks.  Matplotlib import is deferred so
headless installs don't pay for it.
"""

from __future__ import annotations

import numpy as np

from sed_tpu_torch.dsp import gammatone as gt


class ERBFormatter:
    """Axis formatter mapping [0, 1] positions to ERB-scale frequencies."""

    def __init__(self, low_freq: float, high_freq: float,
                 unit: str = 'Hz', places: int = 0):
        self.low_freq = low_freq
        self.high_freq = high_freq
        self.unit = unit
        self.places = places

    def __call__(self, val, pos=None) -> str:
        freq = gt.erb_point(self.low_freq, self.high_freq, val)
        return f'{freq:.{self.places}f} {self.unit}'


def render_gtgram(wave: np.ndarray, fs: int, window_time: float,
                  hop_time: float, channels: int, f_min: float,
                  axes=None, use_fft: bool = True):
    """Plot a (FFT-approximated by default) gammatonegram onto ``axes``."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import FuncFormatter

    if use_fft:
        gtg = gt.fft_gtgram(wave, fs, window_time, hop_time, channels,
                            f_min)
    else:
        gtg = gt.gtgram(wave, fs, window_time, hop_time, channels, f_min)
    z = np.flipud(20 * np.log10(np.maximum(gtg, 1e-10)))

    if axes is None:
        _, axes = plt.subplots()
    duration = len(wave) / fs
    axes.imshow(z, extent=[0, duration, 1, 0], aspect='auto')
    axes.yaxis.set_major_formatter(
        FuncFormatter(ERBFormatter(f_min, fs / 2, unit='Hz', places=0)))
    axes.set_xlabel('Time (s)')
    axes.set_ylabel('Frequency')
    return axes


def render_audio_file(path: str, duration: float = None,
                      use_fft: bool = True, output: str = None,
                      window_time: float = 0.04, channels: int = 64,
                      f_min: float = 20.0):
    """Render a sound file's gammatonegram (the reference CLI's body,
    ``utils/gammatone/plot.py:112-146``): load the file, take the
    leading ``duration`` seconds, render with a half-window hop, save
    to ``output`` (or show interactively when None)."""
    import matplotlib
    if output is not None:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from sed_tpu_torch.data import audio_io

    wave, fs = audio_io.load_audio(path, sr=None)
    if duration:
        wave = wave[:int(duration * fs)]
    fig, axes = plt.subplots()
    axes.set_title(path)
    render_gtgram(wave, fs, window_time, window_time / 2, channels,
                  f_min, axes=axes, use_fft=use_fft)
    if output is not None:
        fig.savefig(output)
        plt.close(fig)
    else:                                            # pragma: no cover
        plt.show()
    return output


def main(argv=None):
    """CLI entry point: plot the gammatonegram of a sound file
    (parity with ``utils/gammatone/plot.py:148-180``; ``--output``
    added for headless use)."""
    import argparse

    parser = argparse.ArgumentParser(
        description='Plots the gammatonegram of a sound file with an '
                    'ERB-scaled frequency axis.')
    parser.add_argument('sound_file',
                        help='The sound file to graph.')
    parser.add_argument('-d', '--duration', type=int,
                        help='Seconds from the start of the audio to '
                             'use (default: the whole file).')
    parser.add_argument('-a', '--accurate', action='store_true',
                        help='Use the full filterbank instead of the '
                             'weighted-FFT approximation (slower, '
                             'more accurate).')
    parser.add_argument('-o', '--output',
                        help='Save the figure to this path instead of '
                             'showing it interactively.')
    args = parser.parse_args(argv)
    render_audio_file(args.sound_file, duration=args.duration,
                      use_fft=not args.accurate, output=args.output)


if __name__ == '__main__':                           # pragma: no cover
    main()
