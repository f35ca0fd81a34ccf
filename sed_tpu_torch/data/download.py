"""AudioSet clip downloader (a copy of ``sed_tpu/data/download.py``,
``download_audioset.py:1-50``).

Resolves YouTube ids via yt-dlp/youtube-dl and crops 10 s segments with
ffmpeg at 16 kHz mono into ``dataset/{training,testing}/<ytid>_<start>.wav``.
Both tools are optional external dependencies — the function raises a
clear error when they're absent (this environment has no network egress).
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import subprocess
from typing import Optional


def _resolver() -> Optional[str]:
    for tool in ('yt-dlp', 'youtube-dl'):
        if shutil.which(tool):
            return tool
    return None


def download_audioset(csv_path: str, out_dir: str,
                      sample_rate: int = 16000,
                      duration: float = 10.0) -> dict:
    """Download the clips listed in an AudioSet segments csv.

    Rows: ``ytid, start, end, labels, ids`` (same format as
    ``read_weak_csv``'s training rows).  Returns counters
    {'downloaded', 'failed'}.
    """
    tool = _resolver()
    if tool is None or shutil.which('ffmpeg') is None:
        raise RuntimeError(
            'download_audioset needs yt-dlp/youtube-dl and ffmpeg on PATH')
    os.makedirs(out_dir, exist_ok=True)
    counts = {'downloaded': 0, 'failed': 0}
    with open(csv_path) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith('#')]
    for row in rows:
        ytid, start = row[0], float(row[1])
        out = os.path.join(out_dir, f'{ytid}_{int(start)}.wav')
        if os.path.exists(out):
            continue
        try:
            lines = subprocess.run(
                [tool, '-g', '-f', 'bestaudio',
                 f'https://www.youtube.com/watch?v={ytid}'],
                check=True, capture_output=True,
                text=True).stdout.strip().splitlines()
            if not lines:      # resolver exited 0 with no URL (gated clip)
                raise RuntimeError('resolver returned no URL')
            subprocess.run(
                ['ffmpeg', '-y', '-ss', str(start), '-i', lines[0],
                 '-t', str(duration), '-ar', str(sample_rate),
                 '-ac', '1', out],
                check=True, capture_output=True)
            counts['downloaded'] += 1
        except (subprocess.CalledProcessError, RuntimeError, OSError) \
                as exc:        # one bad clip must not abort the batch
            logging.warning('failed %s: %s', ytid, exc)
            counts['failed'] += 1
    return counts
