"""HDF5-backed dataset, seeded samplers, the prefetching loader and the
per-process batch share (a copy of ``sed_tpu/data/dataset.py``; the
process index and count come from ``torch.distributed``).

Mirrors ``utils/data_generator.py`` (including ``TrainSampler``'s exact
double-index RNG stream) with one deliberate fix: the dataset keeps HDF5
handles open per (thread, path) instead of reopening the file for every
item (``data_generator.py:37``).  ``h5py`` is imported where a file is
opened: the card machine has none.
"""

from __future__ import annotations

import threading
import queue as queue_mod
import weakref
from typing import Dict, Iterator, List, Optional

import numpy as np

from sed_tpu_torch.data.hdf5_pack import int16_to_float32


class AudiosetDataset:
    """Map-style dataset over packed HDF5 files, keyed by batch meta
    ``{'hdf5_path', 'index_in_hdf5'}`` (``data_generator.py:15-49``).

    Handles are cached PER THREAD (h5py read handles are not
    thread-safe), so the multi-worker ``DataLoader`` can read
    concurrently.  With ``dequantize=False`` waveforms stay int16 as
    packed — the train step dequantizes on device, halving the
    host->device bytes per batch.

    ``wire`` further compresses the batches the workers hand to the
    device: 'mulaw8' (1 byte/sample G.711), 'q6'/'q5'/'q4' (N-bit
    block-scaled, ``audio_io.qn_encode``) or 'adpcm4' — the train step's
    device-side ``ops/wire.dequant_wire`` recognizes all of them.  q6
    ships ~5.2x fewer host->device bytes per step than int16; default
    None ships exact int16.  Implies dequantize=False.
    """

    def __init__(self, dequantize: bool = True,
                 wire: Optional[str] = None):
        # thread-local caches: a dead thread's handles lose their last
        # strong reference and close via GC (h5py closes on __del__), so
        # re-iterated loaders don't accumulate open descriptors
        self._tls = threading.local()
        self._all: List[weakref.ref] = []   # for close() across threads
        self._lock = threading.Lock()
        assert wire in (None, 'int16', 'mulaw8', 'q4', 'q5', 'q6',
                        'adpcm4'), wire
        if wire == 'int16':
            wire = None          # int16 IS the packed storage format
            dequantize = False
        self.wire = wire
        self.dequantize = dequantize and wire is None

    def _encode_wire(self, wav_int16: np.ndarray) -> np.ndarray:
        """(B, S) or (S,) int16 -> the configured wire bytes."""
        from sed_tpu_torch.data import audio_io
        one = wav_int16.ndim == 1
        w = wav_int16[None] if one else wav_int16
        assert w.ndim == 2, (
            'wire compression applies to raw audio (B, S); got shape '
            f'{wav_int16.shape} — gamma-feature batches must use the '
            'int16 default')
        if self.wire == 'mulaw8':
            # mulaw_encode takes int16 natively (exact table lookup; a
            # float32 round-trip would truncate 1-LSB samples)
            out = audio_io.mulaw_encode(w)
        elif self.wire == 'adpcm4':
            # whole-batch on purpose (unlike qN below): the adpcm cost
            # is the spb-step recursion, not cache-sized intermediates;
            # the native encoder (numpy where g++ is missing, bit-exact)
            # loops rows itself either way
            out = audio_io.adpcm_encode(w)
        else:
            # PER-CLIP encode on purpose: one (24, 160000) batch
            # qn_encode builds ~23 MB of bit-matrix intermediates and
            # measured ~6x slower per clip than cache-sized per-clip
            # encodes on the 1-vCPU host (BENCHMARKS.md host-memory
            # pathology)
            bits = int(self.wire[1])
            out = np.stack([audio_io.qn_encode(row[None], bits)[0]
                            for row in w])
        return out[0] if one else out

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
        if self.wire is not None:
            # a single item must be 1-D raw audio; a 2-D item here is a
            # gamma feature matrix which must NOT be companded (the
            # batch path's rank check would mistake it for (B, S))
            assert wav.ndim == 1, (
                f'wire compression applies to raw audio; item shape '
                f'{wav.shape} looks like packed gamma features')
            wav = self._encode_wire(wav)
        elif self.dequantize:
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

        The reference (and the per-item path above) issues one h5py call
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
        if self.wire is not None:
            wav = self._encode_wire(wav)
        elif self.dequantize:
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


def _rows(hdf5_path: str, audios_num: Optional[int]) -> int:
    """The split's row count: ``audios_num`` when the caller gives it,
    else read from the file."""
    if audios_num is not None:
        return int(audios_num)
    import h5py
    with h5py.File(hdf5_path, 'r') as hf:
        return len(hf['audio_name'])


class TrainSampler:
    """Infinite shuffled batch-meta stream, seed 1234, reproducing the
    reference's exact RNG stream (``data_generator.py:52-101``): each
    draw composes the permutation with itself
    (``audio_indexes[audio_indexes[pointer]]``), and a mid-batch
    reshuffle applies the NEW permutation to the OLD first index.
    Distributionally this is just a shuffle, but bit-level training
    trajectories match the reference only with the same stream.

    ``audios_num`` gives the split's row count; without it the file is
    opened to count them (the samplers read nothing else)."""

    def __init__(self, hdf5_path: str, batch_size: int,
                 random_seed: int = 1234,
                 audios_num: Optional[int] = None):
        self.hdf5_path = hdf5_path
        self.batch_size = batch_size
        self.random_state = np.random.RandomState(random_seed)
        self.audios_num = _rows(hdf5_path, audios_num)
        self.audio_indexes = np.arange(self.audios_num)
        self.random_state.shuffle(self.audio_indexes)
        self.pointer = 0

    def __iter__(self) -> Iterator[List[dict]]:
        while True:
            batch_meta = []
            for _ in range(self.batch_size):
                index = int(self.audio_indexes[self.pointer])
                self.pointer += 1
                if self.pointer >= self.audios_num:
                    self.pointer = 0
                    self.random_state.shuffle(self.audio_indexes)
                batch_meta.append({
                    'hdf5_path': self.hdf5_path,
                    'index_in_hdf5': int(self.audio_indexes[index])})
            yield batch_meta


class TestSampler:
    """Sequential batches over a split (``data_generator.py:104-145``)."""

    __test__ = False  # not a pytest class

    def __init__(self, hdf5_path: str, batch_size: int,
                 audios_num: Optional[int] = None):
        self.hdf5_path = hdf5_path
        self.batch_size = batch_size
        self.audios_num = _rows(hdf5_path, audios_num)

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
    for torch DataLoader(num_workers=8), ``main_strong.py:254-268``).

    ``num_workers > 1`` fetches batches with a pool of threads and
    reassembles them in sampler order, overlapping HDF5 reads with each
    other and with device compute (the HDF5 read path releases the GIL
    inside the HDF5 C library)."""

    def __init__(self, dataset: AudiosetDataset, batch_sampler,
                 collate=collate_fn, prefetch: int = 4,
                 num_workers: int = 1):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        # default collate + a hyperslab-capable dataset: one fancy read
        # per HDF5 dataset per batch instead of one per item (measured
        # speedup in BENCHMARKS.md); custom collates keep the item path
        if collate is collate_fn and hasattr(dataset, 'get_batch'):
            self._fetch = dataset.get_batch
        else:
            self._fetch = lambda metas: self.collate(
                [self.dataset[m] for m in metas])

    # -- single-thread path ------------------------------------------------

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
                if not put(self._fetch(batch_meta)):
                    return
            put(None)
        except Exception as exc:  # surface worker errors to the consumer
            put(exc)

    # -- multi-worker path (ordered reassembly) ------------------------------

    def _feed(self, meta_q: queue_mod.Queue, budget: threading.Semaphore,
              stop: threading.Event, out: dict, cond: threading.Condition):
        next_seq = 0
        try:
            for batch_meta in self.batch_sampler:
                budget.acquire()
                if stop.is_set():
                    return
                meta_q.put((next_seq, batch_meta))
                next_seq += 1
        except Exception as exc:    # surfaced at the consumer, in order
            with cond:
                out[next_seq] = exc
                cond.notify_all()
        finally:
            for _ in range(self.num_workers):
                meta_q.put(None)

    def _work(self, meta_q: queue_mod.Queue, out: dict,
              cond: threading.Condition, stop: threading.Event):
        while True:
            item = meta_q.get()
            if item is None or stop.is_set():
                with cond:
                    out['done'] += 1
                    cond.notify_all()
                return
            seq, batch_meta = item
            try:
                batch = self._fetch(batch_meta)
            except Exception as exc:     # surfaced at the consumer
                batch = exc
            with cond:
                out[seq] = batch
                cond.notify_all()

    def _iter_workers(self):
        meta_q: queue_mod.Queue = queue_mod.Queue()
        # how far workers may run ahead of the consumer
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        out: dict = {'done': 0}
        cond = threading.Condition()
        stop = threading.Event()
        threads = [threading.Thread(target=self._feed,
                                    args=(meta_q, budget, stop, out, cond),
                                    daemon=True)]
        threads += [threading.Thread(target=self._work,
                                     args=(meta_q, out, cond, stop),
                                     daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        seq = 0
        try:
            while True:
                with cond:
                    while seq not in out:
                        if out['done'] == self.num_workers:
                            return          # sampler exhausted
                        cond.wait()
                    batch = out.pop(seq)
                if isinstance(batch, Exception):
                    raise batch
                budget.release()
                yield batch
                seq += 1
        finally:
            stop.set()
            budget.release()     # unblock a parked feeder

    def __iter__(self):
        if self.num_workers > 1:
            yield from self._iter_workers()
            return
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


def cycle_iteration(loader: DataLoader):
    """Endless batches (``main_strong.py:35-38``)."""
    while True:
        for batch in loader:
            yield batch


def shard_for_host(batch: Dict[str, np.ndarray],
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """Slice a global batch to this process's share for multi-process
    data loading; single-process setups get the batch unchanged."""
    if process_count is None:
        from sed_tpu_torch.parallel import distributed
        process_index = distributed.rank()
        process_count = distributed.world_size()
    if process_count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        share = n // process_count
        out[k] = v[process_index * share:(process_index + 1) * share]
    return out
