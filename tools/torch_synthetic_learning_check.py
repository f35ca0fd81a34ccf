"""End-to-end learning check of the PyTorch port (counterpart of
``tools/synthetic_learning_check.py``).

Builds the synthetic corpus of ``tools/synthetic_learning_check.py``
(the same seed stream, hence the same clips, labels and names) in
memory, packed as ``sed_tpu_torch.cli.features`` would pack it, and
trains with the training CLI's own loop
(``sed_tpu_torch.cli.main_strong.train_loop``): its samplers,
``AudiosetDataset``, ``DataLoader``, ``--train_wire`` encoding,
``device_prefetch``, joint step, ``Evaluator``, best checkpoint and
statistics.  Only the HDF5 file is replaced, by ``MemoryDataset``; no wav
or HDF5 file is written, only the reference CSVs the ``Evaluator`` scores
against.  Prints the loss every 100 iterations and, at each evaluation,
the validation and test segment ER and F1 and the framewise and clipwise
mAP.  If learning works, framewise mAP rises far above chance within a
few hundred iterations.

Usage:  python tools/torch_synthetic_learning_check.py [workdir]
            [--device cpu] [extra train flags...]

Extra flags go to ``main_strong train`` (later flags win, e.g.
``--compute_dtype bf16 --batch_size 8``); ``--device`` defaults to
``cuda``.  On the CPU a run of 601 iterations takes hours: use it to
debug, and ``python3 chip_smoke.py --learning-only`` on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from sed_tpu_torch import config  # noqa: E402
from sed_tpu_torch.bench_corpus import make_clips  # noqa: E402
from sed_tpu_torch.cli import main_strong  # noqa: E402
from sed_tpu_torch.data import audio_io, metadata  # noqa: E402
from sed_tpu_torch.data.dataset import AudiosetDataset  # noqa: E402
from sed_tpu_torch.data.hdf5_pack import float32_to_int16  # noqa: E402

CFG = config.AUDIO_16K
SPLITS = ('weak_training', 'strong_training', 'strong_validation', 'testing')
SIZES = {'weak_training': 48, 'strong_training': 48,
         'strong_validation': 16, 'testing': 16}
# ``tools/synthetic_learning_check.py``'s train flags
TRAIN_FLAGS = [
    '--model_type', 'Cnn_9layers_Gru_FrameAtt',
    '--loss_type', 'clip_bce', '--augmentation', 'specaugment_mixup',
    '--batch_size', '4', '--feature_type', 'logmel', '--audio_16k',
    '--learning_rate', '1e-3', '--stop_iteration', '601',
    '--eval_interval', '200']


def synth_clip(rng: np.random.RandomState):
    """One 10 s corpus clip from the next seed of ``rng``: (waveform,
    [(label, onset, offset)])."""
    seed = int(rng.randint(1 << 31))
    clips, events = make_clips(1, CFG.sample_rate, seconds=10, seed=seed,
                               return_events=True, min_events=2,
                               max_events=3, min_dur=1.5, max_dur=3.0)
    return clips[0], [(e['event_label'], e['onset'], e['offset'])
                      for e in events[0]]


def packed_waveform(wav: np.ndarray) -> np.ndarray:
    """The int16 row the packer stores for ``wav``: quantized to 16-bit
    PCM as ``audio_io.save_wav`` writes it, read back as ``load_audio``
    reads it, then quantized as ``data/hdf5_pack.py`` packs it."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    audio = audio_io._to_float32(pcm)
    return float32_to_int16(audio_io.pad_truncate(audio, CFG.audio_samples))


@dataclasses.dataclass
class Corpus:
    """The packed splits: ``splits[name]`` holds what the HDF5 file
    would (``waveform`` int16, ``audio_name`` S80 bytes, ``target`` bool,
    and ``strong_target`` bool for the strongly labelled splits), in the
    packer's row order; ``strong_rows[name]`` the split's reference CSV
    lines."""
    splits: Dict[str, dict]
    strong_rows: Dict[str, List[str]]
    seconds: float


def build_corpus(sizes: Optional[dict] = None) -> Corpus:
    """The corpus of ``tools/synthetic_learning_check.build_dataset``:
    one ``RandomState(0)``, one seed a clip, the splits in the order
    weak, strong, validation, testing; packed in memory."""
    t0 = time.perf_counter()
    sizes = sizes or SIZES
    rng = np.random.RandomState(0)
    frames = config.AUDIO_DURATION * CFG.frames_per_second
    splits, strong_rows = {}, {}
    for split in SPLITS:
        n = sizes[split]
        names, wavs, targets, strong, rows = [], [], [], [], []
        for i in range(n):
            wav, spans = synth_clip(rng)
            name = f'{split}{i}_0.wav'
            labels = sorted({lb for lb, _, _ in spans})
            # the strong CSV's rows as read_strong_csv gives them back
            meta = {name: [{'onset': f'{s:.3f}', 'offset': f'{e:.3f}',
                            'label': lb} for lb, s, e in spans]}
            rows += [f'{name},{m["onset"]},{m["offset"]},{m["label"]}\n'
                     for m in meta[name]]
            names.append(name.encode())
            wavs.append(packed_waveform(wav))
            targets.append(metadata.get_weak_target(labels))
            strong.append(metadata.get_strong_target(
                name, meta, frames, CFG.frames_per_second))
        splits[split] = {'audio_name': np.array(names, dtype='S80'),
                         'waveform': np.stack(wavs),
                         'target': np.stack(targets)}
        # the packer adds strong targets where a strong CSV exists
        if split != 'weak_training':
            splits[split]['strong_target'] = np.stack(strong)
        strong_rows[split] = rows
    return Corpus(splits, strong_rows, time.perf_counter() - t0)


class MemoryDataset(AudiosetDataset):
    """``AudiosetDataset`` over the corpus in memory: the handle of a
    split is its dict of arrays in place of the HDF5 file, and the
    dataset's reads, batching and wire encoding run unchanged."""

    def __init__(self, splits: Dict[str, dict], **kwargs):
        super().__init__(**kwargs)
        self.splits = splits

    def _file(self, path: str):
        return self.splits[path]


@dataclasses.dataclass
class Run:
    """One training run: the train state, the arguments, each
    evaluation's metrics (``evaluations[k]``: ``iteration``, ``train_s``,
    ``eval_s`` and, for ``valid`` and ``test``, ``er``, ``f1``,
    ``framewise_map``, ``clipwise_map``), every step's loss, its finite
    flag and loss scale (loss-scaled runs), the best iteration and its
    checkpoint, and the wall of the loop."""
    state: object
    args: object
    workspace: str
    evaluations: List[dict]
    losses: np.ndarray
    grads_finite: List[bool]
    loss_scales: List[float]
    best_iteration: Optional[int]
    best_checkpoint: Optional[str]
    wall_s: float

    @property
    def eval_s(self) -> float:
        return sum(e['eval_s'] for e in self.evaluations)

    @property
    def steps(self) -> int:
        return len(self.losses)

    def best(self, split: str = 'test') -> dict:
        return next(e[split] for e in self.evaluations
                    if e['iteration'] == self.best_iteration)


def summarize(statistics: dict) -> dict:
    """ER, F1, framewise and clipwise mAP of an ``Evaluator`` result."""
    overall = statistics['sed_metrics']['overall']
    return {'er': float(overall['error_rate']['error_rate']),
            'f1': float(overall['f_measure']['f_measure']),
            'framewise_map': float(np.nanmean(statistics['framewise_ap'])),
            'clipwise_map': float(np.nanmean(statistics['clipwise_ap']))}


def train_argv(dataset_dir: str, workspace: str, extra=()) -> List[str]:
    """``main_strong train``'s argv: ``TRAIN_FLAGS``, then ``extra``
    pairwise, later flags winning."""
    argv = ['train', '--dataset_dir', dataset_dir, '--workspace', workspace,
            *TRAIN_FLAGS]
    extra = list(extra)
    for i in range(0, len(extra), 2):
        if extra[i] in argv:
            argv[argv.index(extra[i]) + 1] = extra[i + 1]
        else:
            argv += [extra[i], extra[i + 1]]
    return argv


def write_references(corpus: Corpus, dataset_dir: str) -> None:
    """The validation and test reference CSVs, where
    ``cli/common.reference_csv_paths`` looks for them."""
    meta = os.path.join(dataset_dir, 'metadata')
    os.makedirs(os.path.join(meta, 'strong'), exist_ok=True)
    for split, path in (
            ('strong_validation', os.path.join(
                meta, 'strong',
                'groundtruth_strong_label_strong_validation_set.csv')),
            ('testing', os.path.join(
                meta, 'groundtruth_strong_label_testing_set.csv'))):
        with open(path, 'w') as f:
            f.write(''.join(corpus.strong_rows[split]))


def train(corpus: Corpus, extra=(), workdir: Optional[str] = None,
          verbose: bool = True) -> Run:
    """Train on ``corpus`` through ``main_strong``'s loop with
    ``TRAIN_FLAGS`` and ``extra``; the workspace (checkpoints,
    statistics, logs) and the reference CSVs go under ``workdir`` (a new
    temporary directory by default)."""
    import torch
    workdir = workdir or tempfile.mkdtemp(prefix='sed_torch_learn_')
    dataset_dir = os.path.join(workdir, 'dataset')
    write_references(corpus, dataset_dir)
    args = main_strong.get_parser().parse_args(train_argv(
        dataset_dir, os.path.join(workdir, 'workspace'), extra))
    device, cfg, ws = main_strong.train_setup(args)
    loaders = main_strong.train_loaders(
        args, {split: split for split in SPLITS},
        dataset=functools.partial(MemoryDataset, corpus.splits),
        rows={split: len(d['audio_name'])
              for split, d in corpus.splits.items()})
    losses, finite, scales, evaluations = [], [], [], []

    def on_step(iteration, metrics):
        losses.append(metrics['loss'].detach())
        if 'grads_finite' in metrics:
            finite.append(bool(metrics['grads_finite']))
            scales.append(float(metrics['loss_scale']))
        if verbose and iteration % 100 == 0:
            print(f'iteration {iteration}: loss '
                  f'{float(metrics["loss"]):.4f} (weak '
                  f'{float(metrics["weak_loss"]):.4f}, strong '
                  f'{float(metrics["strong_loss"]):.4f})', flush=True)
        if device.type == 'cuda' and (iteration + 1) % args.eval_interval \
                == 0:
            # the steps before an evaluation finish before it is timed
            torch.cuda.synchronize(device)

    def on_eval(iteration, statistics, train_s, eval_s):
        record = {'iteration': iteration, 'train_s': train_s,
                  'eval_s': eval_s,
                  **{k: summarize(v) for k, v in statistics.items()}}
        evaluations.append(record)
        if verbose:
            print(f'evaluation at {iteration} ({eval_s:.2f} s): ' + '; '.join(
                f'{k} ER {record[k]["er"]:.4f} F1 {record[k]["f1"]:.4f} '
                f'framewise mAP {record[k]["framewise_map"]:.4f} clipwise '
                f'mAP {record[k]["clipwise_map"]:.4f}'
                for k in ('valid', 'test')), flush=True)

    t0 = time.perf_counter()
    state = main_strong.train_loop(args, device, cfg, ws, *loaders,
                                   main_strong.common.reference_csv_paths(
                                       args),
                                   on_step=on_step, on_eval=on_eval)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    # the loop's best checkpoint: BEST names its iteration (none when
    # the run ended before its first evaluation)
    ckpt_dir = ws.checkpoint_path(args.feature_type, cfg.name)
    best = None
    if os.path.isfile(os.path.join(ckpt_dir, 'BEST')):
        with open(os.path.join(ckpt_dir, 'BEST')) as f:
            best = int(f.read())
    run = Run(state=state, args=args, workspace=args.workspace,
              evaluations=evaluations,
              losses=torch.stack(losses).float().cpu().numpy(),
              grads_finite=finite, loss_scales=scales, best_iteration=best,
              best_checkpoint=None if best is None else os.path.join(
                  ckpt_dir, f'iter_{best}.pth'),
              wall_s=wall)
    if verbose:
        print(f'best iteration {best}: test '
              f'{None if best is None else run.best("test")}; '
              f'{run.steps} steps, '
              f'{wall:.1f} s ({run.eval_s:.1f} s of evaluations); '
              f'workspace {args.workspace}', flush=True)
    return run


def main(argv=None) -> Run:
    argv = sys.argv[1:] if argv is None else list(argv)
    workdir = argv.pop(0) if argv and not argv[0].startswith('-') else None
    corpus = build_corpus()
    print(f'corpus of {sum(SIZES.values())} clips of 10 s built in memory '
          f'in {corpus.seconds:.1f} s', flush=True)
    return train(corpus, argv, workdir)


if __name__ == '__main__':
    main()
