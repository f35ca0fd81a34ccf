"""HDF5-backed dataset, the sequential sampler and the prefetching
loader of the evaluation path (a copy of the parts of
``sed_tpu/data/dataset.py`` that ``cli/main_strong.py`` and
``cli/optimize_thresholds.py`` run).

Mirrors ``utils/data_generator.py`` with one deliberate fix: the dataset
keeps HDF5 handles open per (thread, path) instead of reopening the file
for every item (``data_generator.py:37``).  ``h5py`` is imported where a
file is opened.
"""

from __future__ import annotations

import threading
import queue as queue_mod
import weakref
from typing import Dict, Iterator, List

import numpy as np

from sed_tpu_torch.data.hdf5_pack import int16_to_float32


class AudiosetDataset:
    """Map-style dataset over packed HDF5 files, keyed by batch meta
    ``{'hdf5_path', 'index_in_hdf5'}`` (``data_generator.py:15-49``).

    Handles are cached PER THREAD (h5py read handles are not
    thread-safe): each ``DataLoader`` iteration reads on a thread of its
    own.  Waveforms are dequantized to float32 as they are read.
    """

    def __init__(self):
        # thread-local caches: a dead thread's handles lose their last
        # strong reference and close via GC (h5py closes on __del__), so
        # re-iterated loaders don't accumulate open descriptors
        self._tls = threading.local()
        self._all: List[weakref.ref] = []   # for close() across threads
        self._lock = threading.Lock()

    def _file(self, path: str):
        import h5py
        cache = getattr(self._tls, 'handles', None)
        if cache is None:
            cache = self._tls.handles = {}
        hf = cache.get(path)
        if hf is None or not hf.id:
            hf = cache[path] = h5py.File(path, 'r')
            with self._lock:
                self._all = [r for r in self._all if r() is not None]
                self._all.append(weakref.ref(hf))
        return hf

    def __getitem__(self, meta: dict) -> dict:
        hf = self._file(meta['hdf5_path'])
        i = meta['index_in_hdf5']
        wav = hf['waveform'][i]
        wav = int16_to_float32(wav)
        data = {
            'audio_name': hf['audio_name'][i].decode(),
            'waveform': wav,
            'target': hf['target'][i].astype(np.float32),
        }
        if 'strong_target' in hf:
            data['strong_target'] = hf['strong_target'][i].astype(np.float32)
        return data

    def get_batch(self, batch_meta: List[dict]) -> Dict[str, np.ndarray]:
        """Whole batch in ONE hyperslab read per HDF5 dataset.

        The reference (and the per-item path above) makes one h5py call
        per item per dataset — at batch 48 that is ~150 chunked-read
        calls of libhdf5 overhead per step.  Reading the sorted unique
        indices in a single fancy selection and scattering back cuts the
        call count to 3-4 per batch (h5py fancy selection requires
        increasing unique indices; a mid-batch reshuffle can repeat an
        index, hence the inverse scatter).  Output is identical to
        ``collate_fn([self[m] for m in batch_meta])``.
        """
        path = batch_meta[0]['hdf5_path']
        if any(m['hdf5_path'] != path for m in batch_meta):
            return collate_fn([self[m] for m in batch_meta])
        idx = np.fromiter((m['index_in_hdf5'] for m in batch_meta),
                          np.int64, count=len(batch_meta))
        hf = self._file(path)
        uniq, inverse = np.unique(idx, return_inverse=True)
        wav = hf['waveform'][uniq][inverse]
        wav = int16_to_float32(wav)
        data = {
            'audio_name': np.array(
                [n.decode() for n in hf['audio_name'][uniq]])[inverse],
            'waveform': wav,
            'target': hf['target'][uniq].astype(np.float32)[inverse],
        }
        if 'strong_target' in hf:
            data['strong_target'] = \
                hf['strong_target'][uniq].astype(np.float32)[inverse]
        return data

    def close(self):
        with self._lock:
            for r in self._all:
                f = r()
                if f is not None:
                    try:
                        f.close()
                    except Exception:
                        pass
            self._all.clear()
        self._tls = threading.local()


class TestSampler:
    """Sequential batches over a split (``data_generator.py:104-145``)."""

    __test__ = False  # not a pytest class

    def __init__(self, hdf5_path: str, batch_size: int):
        self.hdf5_path = hdf5_path
        self.batch_size = batch_size
        import h5py
        with h5py.File(hdf5_path, 'r') as hf:
            self.audios_num = len(hf['audio_name'])

    def __iter__(self) -> Iterator[List[dict]]:
        for ptr in range(0, self.audios_num, self.batch_size):
            yield [{'hdf5_path': self.hdf5_path, 'index_in_hdf5': i}
                   for i in range(ptr,
                                  min(ptr + self.batch_size,
                                      self.audios_num))]


def collate_fn(list_data_dict: List[dict]) -> Dict[str, np.ndarray]:
    """dict-of-lists -> dict-of-arrays (``data_generator.py:148-164``)."""
    return {key: np.array([d[key] for d in list_data_dict])
            for key in list_data_dict[0]}


class DataLoader:
    """Dataset x sampler with background-thread prefetch (the stand-in
    for torch DataLoader(num_workers=8), ``main_strong.py:254-268``):
    one thread reads whole batches (``AudiosetDataset.get_batch``)
    ahead of the consumer."""

    def __init__(self, dataset: AudiosetDataset, batch_sampler,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.prefetch = prefetch

    def _produce(self, q: queue_mod.Queue, stop: threading.Event):
        def put(item) -> bool:
            # bounded put that notices an abandoned consumer instead of
            # parking forever on a full queue (leaking the thread, the
            # queued batches, and the dataset's HDF5 handles)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue_mod.Full:
                    continue
            return False

        try:
            for batch_meta in self.batch_sampler:
                if stop.is_set():
                    return
                if not put(self.dataset.get_batch(batch_meta)):
                    return
            put(None)
        except Exception as exc:  # surface worker errors to the consumer
            put(exc)

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(q, stop),
                                  daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
