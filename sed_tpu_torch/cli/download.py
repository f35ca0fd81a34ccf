"""AudioSet download CLI (a copy of ``sed_tpu/cli/download.py``,
``download_audioset.py:44-50``).

Mirrors the reference surface: ``--workspace`` (containing
``metadata/{data_type}_set.csv``) and ``--data_type
{training,testing}``; clips land in ``<workspace>/dataset/<data_type>/
<ytid>_<start>.wav`` as 10 s 16 kHz mono wavs.  Requires
yt-dlp/youtube-dl and ffmpeg on PATH (no network in the test
environment — the library function raises a clear error when absent).
"""

from __future__ import annotations

import argparse
import os
import sys

from sed_tpu_torch.data.download import download_audioset


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Extract AudioSet')
    parser.add_argument('--workspace', type=str, required=True,
                        help='Directory of your workspace.')
    parser.add_argument('--data_type', type=str, required=True,
                        choices=['training', 'testing'])
    args = parser.parse_args(argv)

    csv_path = os.path.join(args.workspace, 'metadata',
                            f'{args.data_type}_set.csv')
    out_dir = os.path.join(args.workspace, 'dataset', args.data_type)
    counts = download_audioset(csv_path, out_dir)
    print(f"downloaded {counts['downloaded']}, failed {counts['failed']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
