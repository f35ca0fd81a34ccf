"""Pack audio + labels into HDF5 (a copy of ``sed_tpu/data/hdf5_pack.py``;
schema parity with the reference).

Dataset layout matches ``utils/features.py:307-341`` so packed files are
interchangeable with the reference's and with ``sed_tpu``'s:

* ``audo/audio_name``: S80 bytes
* ``waveform``: int16 (N, samples) — or gammatone int16 (N, 64, 994)
  when ``feature_type='gamma'`` (``utils/features.py:318-322,361-370``)
* ``target``: bool (N, classes)
* ``strong_target``: bool (N, frames, classes) when strong labels exist

File naming: ``{data_type}_{feature_type}_{quality}.h5``
(``utils/features.py:277``), with a ``minidata_`` prefix for the 100-clip
debug subset (``utils/features.py:274-275,299-302``).

The gammatone feature is the numpy ``dsp/gammatone.fft_gtgram_db`` in
float64, cast with ``astype(np.int16)`` (truncation toward zero), as
``sed_tpu`` packs it; the float32 ``fft_gtgram_batch`` would flip values
that lie at an integer.  ``h5py`` is imported where a file is written:
the card machine has none.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from sed_tpu_torch import config as sed_config
from sed_tpu_torch.config import AudioConfig
from sed_tpu_torch.data import audio_io, metadata


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    """Peak-normalize-if-clipping then quantize
    (``utils/utilities.py:73-76``)."""
    if np.max(np.abs(x)) > 1.0:
        x = x / np.max(np.abs(x))
    return (x * 32767.0).astype(np.int16)


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    return (x / 32767.0).astype(np.float32)


def hdf5_filename(data_type: str, feature_type: str, quality: str,
                  mini_data: bool = False) -> str:
    prefix = 'minidata_' if mini_data else ''
    return f'{prefix}{data_type}_{feature_type}_{quality}.h5'


def pack_audio_files_to_hdf5(audios_dir: str, csv_path: str,
                             packed_hdf5_path: str, data_type: str,
                             cfg: AudioConfig,
                             feature_type: str = 'logmel',
                             strong_csv_path: Optional[str] = None,
                             mini_data: bool = False) -> str:
    """Pack a split into HDF5 (``utils/features.py:179-383``).

    Args:
      audios_dir: directory holding the wav clips.
      csv_path: weak label csv for the split.
      packed_hdf5_path: output path.
      data_type: split name (controls csv parsing).
      strong_csv_path: optional strong label csv -> adds strong_target.
    """
    import h5py
    meta_list = metadata.read_weak_csv(csv_path, data_type)
    if mini_data:
        meta_list = meta_list[:100]
    strong_meta = (metadata.read_strong_csv(strong_csv_path)
                   if strong_csv_path else None)

    n = len(meta_list)
    classes_num = sed_config.CLASSES_NUM
    frames_num = sed_config.AUDIO_DURATION * cfg.frames_per_second
    audio_samples = cfg.audio_samples

    os.makedirs(os.path.dirname(packed_hdf5_path) or '.', exist_ok=True)
    t0 = time.time()
    with h5py.File(packed_hdf5_path, 'w') as hf:
        hf.create_dataset('audio_name', shape=(n,), dtype='S80')
        if feature_type == 'gamma':
            from sed_tpu_torch.dsp import gammatone
            gamma_frames = gammatone.gtgram_frames(cfg, audio_samples)
            hf.create_dataset(
                'waveform', shape=(n, cfg.mel_bins, gamma_frames),
                dtype=np.int16)
        else:
            hf.create_dataset('waveform', shape=(n, audio_samples),
                              dtype=np.int16)
        hf.create_dataset('target', shape=(n, classes_num), dtype=bool)
        if strong_meta is not None:
            hf.create_dataset('strong_target',
                              shape=(n, frames_num, classes_num),
                              dtype=bool)

        for i, meta in enumerate(meta_list):
            audio_name = meta['audio_name']
            audio_path = os.path.join(audios_dir, audio_name)
            try:
                audio, _ = audio_io.load_audio(audio_path,
                                               sr=cfg.sample_rate)
            except (FileNotFoundError, ValueError) as exc:
                logging.warning('skip %s: %s', audio_path, exc)
                audio = np.zeros(audio_samples, np.float32)
            audio = audio_io.pad_truncate(audio, audio_samples)

            hf['audio_name'][i] = audio_name.encode()
            if feature_type == 'gamma':
                from sed_tpu_torch.dsp import gammatone
                feat = gammatone.fft_gtgram_db(audio, cfg)
                hf['waveform'][i] = feat.astype(np.int16)
            else:
                hf['waveform'][i] = float32_to_int16(audio)
            hf['target'][i] = metadata.get_weak_target(meta['labels'])
            if strong_meta is not None:
                hf['strong_target'][i] = metadata.get_strong_target(
                    audio_name, strong_meta, frames_num,
                    cfg.frames_per_second)

    logging.info('packed %d clips to %s in %.1fs', n, packed_hdf5_path,
                 time.time() - t0)
    return packed_hdf5_path
