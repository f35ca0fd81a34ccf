"""sed_tpu_torch's multi-device training and serving on the CPU.

The data-parallel step runs in gloo processes (``spawn``, meeting through
a ``FileStore`` file, joined with a timeout by
``parallel.distributed.spawn_ranks``; rank functions in
``tests/torch_parallel_workers.py``) on the narrow CnnSed of the
training tests (1 s clips, weak 4 + strong 4 rows) and is held to the
single-process step on the global batch, with mixup, SpecAugment and
timeshift on: gradients within 1e-5 of each tensor's max |g| (the global
BatchNorm sums in another order), BatchNorm running statistics within
1e-6, the parameters after the AMSGrad step within the 1-step bounds of
``chip_smoke.py:STATE_TOL`` (its first update is ~lr * sign(g), so float
noise on a near-zero gradient moves an element by 2 lr).  The wiring
(``maybe_initialize``, ``HostShardedSampler``, ``shard_for_host``) is
held to ``sed_tpu``'s semantics and the engine over several CPU replicas
to one device, events and XML identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sed_tpu.data.dataset import shard_for_host as jax_shard_for_host
from sed_tpu.parallel.distributed import \
    HostShardedSampler as JaxHostShardedSampler
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.config import AUDIO_16K
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.data.dataset import shard_for_host
from sed_tpu_torch.models.blocks import init_weights
from sed_tpu_torch.parallel import distributed
from sed_tpu_torch.parallel.distributed import (HostShardedSampler,
                                                maybe_initialize,
                                                spawn_ranks)
from sed_tpu_torch.serve.engine import SedInferenceEngine
from sed_tpu_torch.serve.streaming import StreamingSed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402

CFG = AUDIO_16K
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
TIMEOUT = 240.0
LR = 1e-3


# ---------------------------------------------------------------------------
# process-group wiring (tests/test_distributed.py, tests/test_data.py:136)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_torchrun_env(monkeypatch):
    for var in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_maybe_initialize_noop_without_env(no_torchrun_env):
    assert maybe_initialize() is False
    assert distributed.rank() == 0 and distributed.world_size() == 1


def test_maybe_initialize_rejects_partial_env(no_torchrun_env):
    """A half-wired launch is a loud configuration error, not a fleet of
    independent single-process runs."""
    no_torchrun_env.setenv('MASTER_ADDR', 'localhost')
    no_torchrun_env.setenv('MASTER_PORT', '29500')
    with pytest.raises(RuntimeError, match='RANK') as exc:
        maybe_initialize()
    assert "['MASTER_ADDR', 'MASTER_PORT'] set" in str(exc.value)


def test_full_torchrun_env_initialises_the_group(no_torchrun_env):
    """All five variables: ``init_process_group`` from the environment,
    gloo for the CPU, NCCL (and the local card) for CUDA."""
    import torch.distributed as dist
    calls, cards = [], []
    no_torchrun_env.setattr(dist, 'init_process_group',
                            lambda backend, **kw: calls.append((backend, kw)))
    no_torchrun_env.setattr(dist, 'get_rank', lambda: 1)
    no_torchrun_env.setattr(dist, 'get_world_size', lambda: 2)
    no_torchrun_env.setattr(torch.cuda, 'set_device', cards.append)
    for k, v in zip(distributed.TORCHRUN_ENV,
                    ('1', '2', '1', 'localhost', '29500')):
        no_torchrun_env.setenv(k, v)
    assert maybe_initialize('cpu') is True
    assert maybe_initialize('cuda') is True
    assert calls == [('gloo', {'init_method': 'env://'}),
                     ('nccl', {'init_method': 'env://'})]
    assert cards == [1]
    assert distributed.local_device('cuda') == torch.device('cuda', 1)
    assert distributed.local_device('cpu') == torch.device('cpu')


def test_partial_env_error_names_the_variables_set(no_torchrun_env):
    no_torchrun_env.setenv('WORLD_SIZE', '4')
    with pytest.raises(RuntimeError) as exc:
        maybe_initialize()
    assert "['WORLD_SIZE'] set" in str(exc.value)
    assert 'LOCAL_RANK' in str(exc.value)


def test_host_sharded_sampler_slices_disjoint_and_complete():
    batches = [[{'i': i, 'b': b} for i in range(8)] for b in range(3)]
    shards = [list(HostShardedSampler(batches, process_index=k,
                                      process_count=4))
              for k in range(4)]
    for b in range(3):
        seen = [m['i'] for k in range(4) for m in shards[k][b]]
        assert seen == list(range(8))
        assert all(len(shards[k][b]) == 2 for k in range(4))
    for k in range(4):
        assert shards[k] == list(JaxHostShardedSampler(batches, k, 4))
    assert list(HostShardedSampler(batches)) == batches   # no group
    assert list(HostShardedSampler(batches, 0, 1)) == batches


def test_host_sharded_sampler_rejects_indivisible_and_odd_shares():
    with pytest.raises(AssertionError):
        list(HostShardedSampler([[{'i': i} for i in range(7)]], 0, 2))
    with pytest.raises(AssertionError, match='even'):
        list(HostShardedSampler([[{'i': i} for i in range(6)]], 0, 2,
                                even_shares=True))


def test_loader_over_host_sharded_sampler(tmp_path):
    """The local loader stream equals the matching slice of the global
    stream for every simulated process."""
    import h5py
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TrainSampler)
    path = str(tmp_path / 'weak_training_logmel_16k.h5')
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w') as hf:
        hf.create_dataset('audio_name',
                          data=[f'c{i}.wav'.encode() for i in range(8)])
        hf.create_dataset('waveform',
                          data=rng.randint(-100, 100, (8, 64), np.int16))
        hf.create_dataset('target', data=rng.rand(8, 25) > 0.8)
    ds = AudiosetDataset()
    it = iter(DataLoader(ds, TrainSampler(path, 4)))
    global_batches = [next(it) for _ in range(3)]
    for k in range(2):
        local_it = iter(DataLoader(
            ds, HostShardedSampler(TrainSampler(path, 4), process_index=k,
                                   process_count=2), num_workers=2))
        for b in range(3):
            np.testing.assert_array_equal(
                next(local_it)['waveform'],
                global_batches[b]['waveform'][k * 2:(k + 1) * 2])
    ds.close()


def test_shard_for_host():
    batch = {'x': np.arange(8), 'y': np.arange(16).reshape(8, 2)}
    for k in range(4):
        got = shard_for_host(batch, process_index=k, process_count=4)
        want = jax_shard_for_host(batch, process_index=k, process_count=4)
        for key in batch:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        shard_for_host(batch, 1, 2)['x'], [4, 5, 6, 7])
    assert shard_for_host(batch) is batch             # no group


def test_world_size_must_divide_the_batches():
    from sed_tpu_torch.cli.common import check_world_size
    check_world_size(2, 12, 4, mixup=True)
    check_world_size(3, 3, 3, mixup=False)
    with pytest.raises(SystemExit, match='weak 12, strong 4'):
        check_world_size(4, 12, 4, mixup=True)        # odd share of 4
    with pytest.raises(SystemExit, match='strong batch of 4'):
        check_world_size(3, 12, 4, mixup=False)


# ---------------------------------------------------------------------------
# the data-parallel step against one process on the global batch
# ---------------------------------------------------------------------------

def _global_batches(seed=0, n=4, bad_row=None):
    rng = np.random.RandomState(seed)
    sr = CFG.sample_rate
    weak = {'waveform': rng.uniform(-0.3, 0.3, (n, sr)).astype(np.float32),
            'target': (rng.rand(n, 25) > 0.7).astype(np.float32)}
    strong = {'waveform': rng.uniform(-0.3, 0.3, (n, sr)).astype(np.float32),
              'strong_target': (rng.rand(n, 100, 25) > 0.8)
              .astype(np.float32)}
    for b in (weak, strong):
        lam = rng.rand(n // 2)
        b['mixup_lambda'] = np.stack([lam, 1 - lam], 1).reshape(-1) \
            .astype(np.float32)
    return weak, strong


def _fresh(temporal, seed=0):
    model = workers.narrow_model(temporal)
    init_weights(model, torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _single(temporal, state_dict, weak, strong, seed):
    """The single-process step on the global batch."""
    model = workers.narrow_model(temporal, state_dict)
    state, step = workers.step_for(model)
    t = lambda b: {k: torch.from_numpy(v.copy())  # noqa: E731
                   for k, v in b.items()}
    metrics = step(t(weak), [t(strong)], torch.Generator().manual_seed(seed))
    return workers._result(state, metrics)


def _check_same_step(got: dict, want: dict) -> dict:
    """Gradients within 1e-5 of each tensor's max |g| (measured up to
    2.5e-6) plus a floor of 1e-6 of the model's largest gradient:
    ``att_block.att.bias``'s exact gradient is 0 (a softmax does not see
    a shift common to its inputs), so both sides hold float32 noise of
    ~1e-7 of the largest gradient there (``tests/test_torch_train.py``'s
    step test allows 2e-7; the global BatchNorm's other order of sums
    measured 1e-7 to 2.2e-7).  Running statistics within 1e-6 (relative
    above 1), losses within 1e-6 relative, the parameters within the
    AMSGrad 1-step bounds.  Returns the worst numbers."""
    worst = {'grad': 0.0, 'bn': 0.0}
    floor = 1e-6 * max(g.abs().max() for g in want['grads'].values())
    for k, g in want['grads'].items():
        d = ((got['grads'][k] - g).abs().max() - floor).clamp_min(0) \
            / g.abs().max().clamp_min(1e-30)
        worst['grad'] = max(worst['grad'], d.item())
        assert d <= 1e-5, (k, d.item())
    diffs = []
    for k, w in want['state'].items():
        v = got['state'][k]
        if 'running' in k:
            d = ((v - w).abs() / w.abs().clamp_min(1.0)).max().item()
            worst['bn'] = max(worst['bn'], d)
            assert d <= 1e-6, (k, d)
        elif 'num_batches' in k:
            assert torch.equal(v, w), k
        else:
            diffs.append((v - w).abs().reshape(-1).double())
    d = torch.cat(diffs)
    worst.update(param_max=d.max().item(), param_mean=d.mean().item(),
                 share=(d > 1e-5).double().mean().item())
    assert worst['param_max'] <= 2 * LR and worst['param_mean'] <= 1e-6 \
        and worst['share'] <= 1e-2, worst
    for key in ('loss', 'weak_loss', 'strong_loss'):
        assert abs(got['metrics'][key] - want['metrics'][key]) <= \
            1e-6 * abs(want['metrics'][key]), key
    assert got['step'] == want['step'] == 1
    return worst


TEMPORALS = ('gru', 'multihead')


@pytest.fixture(scope='module')
def dp_runs(tmp_path_factory):
    """One pair of gloo ranks for the data-parallel step of each temporal
    module (batches of seed 1, generator seed 3) and the skip test (an
    ``inf`` in global weak row 3, rank 1's share)."""
    weak, strong = _global_batches(seed=1)
    runs = [(t, _fresh(t), weak, strong, 3) for t in TEMPORALS]
    bad = _global_batches(seed=2)
    steps, skips = zip(*spawn_ranks(
        workers.dp_steps, 2, (runs, (_fresh('gru', 1), *bad, 3)),
        timeout=TIMEOUT, store_dir=str(tmp_path_factory.mktemp('dp'))))
    return runs, steps, skips


@pytest.mark.parametrize('i', range(len(TEMPORALS)), ids=TEMPORALS)
def test_dp_step_over_2_processes_equals_one_process(i, dp_runs):
    """2 gloo ranks, weak 2 + strong 2 rows each, mixup, SpecAugment and
    timeshift on (and the Transformer's dropouts): the step of each rank
    equals the single-process step on the global batch, and the two
    ranks are bit-identical."""
    runs, steps, _ = dp_runs
    temporal, sd, weak, strong, seed = runs[i]
    want = _single(temporal, sd, weak, strong, seed)
    _check_same_step(steps[0][i], want)
    for k, v in steps[0][i]['state'].items():
        assert torch.equal(v, steps[1][i]['state'][k]), k


def test_nonfinite_sample_on_one_rank_skips_every_rank(dp_runs):
    """An ``inf`` in rank 1's share of the weak batch: both ranks skip
    (the finite flag is agreed), every tensor of the model and of AMSGrad
    bit-identical to before, the scale halved on both, the ranks equal."""
    skips = dp_runs[2]
    for r in skips:
        assert not r['finite'] and r['unchanged'] and r['step'] == 1
        assert r['scale'] == (4096.0, 2048.0)
    for k, v in skips[0]['state'].items():
        assert torch.equal(v, skips[1]['state'][k]), k


def test_dp_x_fsdp_over_4_processes_equals_dp(tmp_path):
    """A ('data', 'model') = (2, 2) mesh, the parameters of at least 512
    elements sharded over 'model' (``conv_block4.conv2.weight`` held as
    half its rows), one step: equal to the single-process step on the
    global batch (and so to dp) within the same bounds; the two ranks of
    a data row see the same rows and the four ranks end equal."""
    weak, strong = _global_batches(seed=4)
    sd = _fresh('gru', 2)
    want = _single('gru', sd, weak, strong, seed=5)
    got = spawn_ranks(workers.dp_fsdp_step, 4,
                      ('gru', sd, weak, strong, 5), timeout=TIMEOUT,
                      store_dir=str(tmp_path))
    assert 'conv_block4.conv2' in got[0]['wrapped']
    assert got[0]['shard'] == (16, 32, 3, 3)
    _check_same_step(got[0], want)
    for r in got[1:]:
        for k, v in got[0]['state'].items():
            assert torch.equal(v, r['state'][k]), k


def test_main_strong_train_under_2_processes(tmp_path):
    """``main_strong train`` on two gloo ranks of an initialised group
    (as torchrun with ``--device cpu`` gives them): both ranks end on the
    same state; rank 0 alone writes the lineage, the statistics, the
    submission and the log (one file each)."""
    ds, ws = _pack(tmp_path)
    argv = ['train', '--dataset_dir', ds, '--workspace', ws,
            '--model_type', 'Cnn_9layers_FrameAvg', '--batch_size', '2',
            '--audio_16k', '--stop_iteration', '2', '--eval_interval', '1',
            '--device', 'cpu', '--num_workers', '1']
    got = spawn_ranks(workers.cli_train, 2, (argv,), timeout=TIMEOUT,
                      store_dir=str(tmp_path))
    assert got[0]['step'] == got[1]['step'] == 2
    for k, v in got[0]['state'].items():
        assert torch.equal(v, got[1]['state'][k]), k
    written = sorted(os.path.basename(f) for d, _, fs in os.walk(ws)
                     for f in fs if not f.endswith('.h5'))
    # the statistics and their dated backup, BEST and the best
    # checkpoint, one submission, one log
    assert len(written) == 6, written
    assert written[:4] == ['0000.log', 'BEST', '_submission.csv',
                           'iter_1.pth'], written
    assert written[4] == 'statistics_logmel_16k.pkl', written


def _pack(tmp_path):
    """``tests/test_torch_train_cli.py``'s dataset layout (2/2/3/3
    bench-corpus clips of 10 s), packed with the port's packer."""
    import csv
    from sed_tpu_torch.cli import features as features_cli
    root = tmp_path / 'dataset'
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)
    splits = {'weak_training': 2, 'strong_training': 2,
              'strong_validation': 3, 'testing': 3}
    for s, (split, n) in enumerate(splits.items()):
        clips, events = make_clips(n, CFG.sample_rate, seconds=10,
                                   seed=60 + s, return_events=True)
        (root / split).mkdir()
        weak, strong = [], []
        for i, (audio, evs) in enumerate(zip(clips, events)):
            name = f'{split}{i}_0.wav'
            audio_io.save_wav(str(root / split / name), audio,
                              CFG.sample_rate)
            labels = ','.join(sorted({e['event_label'] for e in evs}))
            weak.append([f'{split}{i}', '0.000', '10.000', labels, '/m/x'])
            strong += [[name, e['onset'], e['offset'], e['event_label']]
                       for e in evs]
        sub = meta if split == 'testing' else meta / 'strong'
        for path, rows in ((sub / f'{split}_set.csv', weak),
                           (sub / f'groundtruth_strong_label_{split}_set.csv',
                            strong)):
            with open(path, 'w', newline='') as f:
                csv.writer(f).writerows(rows)
    ws = str(tmp_path / 'ws')
    for split in splits:
        features_cli.main(['pack_audio_files_to_hdf5', '--dataset_dir',
                           str(root), '--workspace', ws, '--data_type',
                           split, '--audio_16k'])
    return str(root), ws


# ---------------------------------------------------------------------------
# serving on several devices (tests/test_serve.py:72-117)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def engines():
    model = load_npz(CKPT, 'Cnn_9layers_Gru_FrameAtt', CFG, 'cpu')
    one = SedInferenceEngine(model, CFG, 'cpu', batch_size=4)
    two = SedInferenceEngine(model, CFG, devices=['cpu', 'cpu'],
                             batch_size=4)
    return one, two


def test_replicated_engine_matches_one_device(engines):
    """``devices=['cpu', 'cpu']``: two replicas, each batch split in two;
    ``predict_clips`` on int16 (a ragged last batch: 5 clips, its one
    row on the first replica alone), on the
    adpcm4 and q6 wires, ``predict_clips_stream`` and the windowed path
    give events and XML identical to the single-device engine."""
    one, two = engines
    assert len(two.replicas) == 2 and two.replicas[0] is two.model
    assert two.replicas[1] is not two.model
    clips = make_clips(5, CFG.sample_rate, seconds=5, seed=29)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    for wire in (pcm, audio_io.adpcm_encode_np(clips),
                 audio_io.qn_encode(clips, 6)):
        got, want = two.predict_clips(wire), one.predict_clips(wire)
        assert got == want
        assert sum(map(len, got[0])) > 0
    chunks = [pcm[i:i + 4] for i in range(0, 5, 4)]
    assert two.predict_clips_stream(iter(chunks)) == \
        one.predict_clips_stream(iter(chunks))
    clips10 = make_clips(2, CFG.sample_rate, seconds=10, seed=30)
    names = [f'c{i}.wav' for i in range(2)]
    assert two.predict_clips_windowed(clips10, names, 10.0, 1.0) == \
        one.predict_clips_windowed(clips10, names, 10.0, 1.0)


def test_replicated_engine_checks_its_devices(engines):
    one, two = engines
    model = one.model
    with pytest.raises(ValueError, match='divide evenly over 3 devices'):
        SedInferenceEngine(model, CFG, devices=['cpu'] * 3, batch_size=4)
    with pytest.raises(ValueError, match='one device'):
        StreamingSed(two)
    assert StreamingSed(one).engine is one
    assert [str(d) for d in two.devices] == ['cpu', 'cpu']


def test_dryrun_cli_answers_help():
    proc = subprocess.run(
        [sys.executable, '-m', 'sed_tpu_torch.parallel.dryrun', '--help'],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and 'gloo' in proc.stdout
