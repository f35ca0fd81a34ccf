"""The port's learning check and bench-checkpoint maker on the CPU, held
to ``sed_tpu``:

* ``eval/ap.py`` (numpy) bit-equal to ``sed_tpu/eval/ap.py`` (sklearn);
* the in-memory corpus of ``tools/torch_synthetic_learning_check.py``
  equal to ``tools/synthetic_learning_check.build_dataset`` packed by the
  port's packer, and its run of the CLI's loop bitwise equal to
  ``main_strong train`` on those files;
* ``utils/npz_ckpt.save_variables_npz`` equal to ``sed_tpu``'s writer,
  ``compat/from_flax.variables_from_model`` the inverse of the loader,
  and an exported ``.npz`` served by ``sed_tpu`` as by the port;
* the samplers with a row count equal to the samplers that read it.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_16K
from sed_tpu.eval import ap as jax_ap
from sed_tpu.utils import npz_ckpt as jax_npz
from sed_tpu_torch.cli import features as features_cli
from sed_tpu_torch.cli import main_strong
from sed_tpu_torch.compat import from_flax
from sed_tpu_torch.eval import ap
from sed_tpu_torch.utils import npz_ckpt
from sed_tpu_torch.utils.paths import Workspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import torch_make_bench_checkpoint as make_ckpt  # noqa: E402
import torch_synthetic_learning_check as learning  # noqa: E402
from synthetic_learning_check import build_dataset  # noqa: E402

CFG = AUDIO_16K
GRU = 'Cnn_9layers_Gru_FrameAtt'
CONFORMER = 'Cnn_9layers_Conformer_FrameAtt'
BENCH = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
SIZES = dict.fromkeys(learning.SPLITS, 2)
# the loop run of both: the tool's flags (specaugment_mixup: weak batches
# of 12, strong of 4) on the smallest full-width model, 3 iterations with
# an evaluation at 2
RUN_FLAGS = ['--model_type', 'Cnn_9layers_FrameAvg', '--batch_size', '2',
             '--stop_iteration', '3',
             '--eval_interval', '2', '--device', 'cpu']


def _ap_case(case, rng):
    n, c = 200, 6
    target = (rng.rand(n, c) < 0.3).astype(np.float32)
    out = rng.rand(n, c).astype(np.float32)
    if case == 'ties':
        out = np.round(out * 4) / 4            # five distinct scores
        out[:50, 0] = 0.5
    elif case == 'no_positive':
        target[:, 2] = 0
    elif case == 'all_positive':
        target[:, 3] = 1
    elif case == 'framewise':
        return ((rng.rand(4, 50, c) < 0.2).astype(np.float32),
                rng.rand(4, 50, c).astype(np.float32))
    elif case == 'bool_framewise_float64':
        return (rng.rand(3, 40, c) < 0.2,
                np.round(rng.rand(3, 40, c), 2))
    return target, out


@pytest.mark.parametrize('case', ['random', 'ties', 'no_positive',
                                  'all_positive', 'framewise',
                                  'bool_framewise_float64'])
@pytest.mark.filterwarnings('ignore:No positive class found')
def test_average_precision_equals_sklearn_through_sed_tpu(case):
    """The numpy AP (sklearn's steps per column) is bit-equal to
    ``sed_tpu``'s sklearn AP per class; a column with no positive gives
    0."""
    target, out = _ap_case(case, np.random.RandomState(len(case)))
    if target.ndim == 3:
        got = ap.sed_average_precision(target, out)
        want = jax_ap.sed_average_precision(target, out)
    else:
        got = ap.clipwise_average_precision(target, out)
        want = jax_ap.clipwise_average_precision(target, out)
    assert got.dtype == want.dtype and np.array_equal(got, want), (got, want)
    if case == 'no_positive':
        assert got[2] == 0.0
    if case == 'all_positive':
        assert got[3] == 1.0


@pytest.fixture(scope='module')
def packed(tmp_path_factory):
    """``sed_tpu``'s ``build_dataset`` at 2 clips a split, packed by the
    port's packer: (dataset dir, workspace)."""
    root = str(tmp_path_factory.mktemp('learning'))
    dataset, ws = os.path.join(root, 'dataset'), os.path.join(root, 'ws')
    build_dataset(dataset, SIZES)
    for split in learning.SPLITS:
        features_cli.main(['pack_audio_files_to_hdf5', '--dataset_dir',
                           dataset, '--workspace', ws, '--data_type', split,
                           '--audio_16k'])
    return dataset, ws


@pytest.fixture(scope='module')
def corpus():
    return learning.build_corpus(SIZES)


def test_memory_corpus_equals_the_packed_build_dataset(packed, corpus):
    """Every split's waveform (int16), audio names (row order), target
    and strong target equal the packed files; the reference CSVs equal
    ``build_dataset``'s."""
    import h5py
    dataset, ws = packed
    for split in learning.SPLITS:
        with h5py.File(os.path.join(ws, 'hdf5s',
                                    f'{split}_logmel_16k.h5'), 'r') as hf:
            want = {k: hf[k][()] for k in hf}
        got = corpus.splits[split]
        assert sorted(got) == sorted(want), split
        for key in want:
            assert got[key].dtype == want[key].dtype, (split, key)
            assert np.array_equal(got[key], want[key]), (split, key)
    assert corpus.splits['testing']['strong_target'].any()
    learning.write_references(corpus, os.path.join(dataset, 'copy'))
    for rel in ('strong/groundtruth_strong_label_strong_validation_set.csv',
                'groundtruth_strong_label_testing_set.csv'):
        with open(os.path.join(dataset, 'metadata', rel)) as f, \
                open(os.path.join(dataset, 'copy', 'metadata', rel)) as g:
            assert f.read() == g.read(), rel


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return a == b or (a != a and b != b)


@pytest.fixture(scope='module')
def runs(packed, corpus, tmp_path_factory):
    """``main_strong train`` on the packed files, and the tool's run of
    the loop on the corpus in memory, with the same flags."""
    dataset, ws = packed
    cli_state = main_strong.main(learning.train_argv(dataset, ws,
                                                     RUN_FLAGS))
    run = learning.train(corpus, RUN_FLAGS,
                         str(tmp_path_factory.mktemp('tool')),
                         verbose=False)
    return ws, cli_state, run


def test_tool_loop_equals_main_strong_train(runs):
    """After 3 iterations the parameters and BatchNorm buffers are
    bitwise equal, the statistics pickles equal, the best checkpoint is
    the same iteration; the run reports the evaluation at 2 (the loop
    does not evaluate at 0) and three finite losses."""
    ws, cli_state, run = runs
    assert run.state.step == cli_state.step == 3
    want = cli_state.model.state_dict()
    got = run.state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    stats = []
    for root in (ws, run.workspace):
        path = Workspace(root=root, model_type='Cnn_9layers_FrameAvg',
                         loss_type='clip_bce',
                         augmentation='specaugment_mixup',
                         batch_size=2).statistics_path('logmel', '16k')
        with open(path, 'rb') as f:
            stats.append(pickle.load(f))
    assert [s['iteration'] for s in stats[0]['test']] == [2]
    assert _equal(stats[0], stats[1])
    assert [e['iteration'] for e in run.evaluations] == [2]
    assert run.best_iteration == 2 and os.path.isfile(run.best_checkpoint)
    assert run.best('test') == learning.summarize(stats[0]['test'][0])
    assert run.losses.shape == (3,) and np.isfinite(run.losses).all()
    assert run.grads_finite == [] and run.loss_scales == []


def test_make_bench_checkpoint_exports_the_best_checkpoint(runs, tmp_path):
    """The exporter writes the run's best ``.pth`` as the float16 cast of
    its flax tree (and refuses ``tools/bench_checkpoint.npz``); the
    tool's argv keeps the JAX tool's flags with 801 iterations, from
    ``sed_tpu``'s initialisation written as a float32 ``.npz``."""
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    _, _, run = runs
    out = make_ckpt.export(run, str(tmp_path / 'x.npz'))
    tree = npz_ckpt._flatten(from_flax.variables_from_model(load_checkpoint(
        run.best_checkpoint, 'Cnn_9layers_FrameAvg', CFG, 'cpu')))
    _bitwise_same(_flat(out), {k: v.astype(np.float16)
                               for k, v in tree.items()})
    with pytest.raises(SystemExit, match='oracle'):
        make_ckpt.export(run, BENCH)
    flags = make_ckpt.train_flags(str(tmp_path))
    args = main_strong.get_parser().parse_args(
        learning.train_argv('d', 'w', flags))
    assert (args.stop_iteration, args.eval_interval, args.batch_size,
            args.model_type, args.augmentation, args.device) == (
        801, 200, 4, GRU, 'specaugment_mixup', 'cuda')
    # the run starts from sed_tpu's initialisation, stored in float32
    from sed_tpu_torch.compat.flax_init import gru_frameatt_variables
    from sed_tpu_torch.compat.from_flax import load_npz
    init = from_flax.variables_from_model(load_npz(args.checkpoint, GRU,
                                                   CFG, 'cpu'))
    _bitwise_same(npz_ckpt._flatten(init), npz_ckpt._flatten(
        gru_frameatt_variables(init)))
    assert make_ckpt.SIZES == {'weak_training': 96, 'strong_training': 96,
                               'strong_validation': 24, 'testing': 24}
    assert os.path.abspath(make_ckpt.OUT) != os.path.abspath(BENCH)


def _flat(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _bitwise_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].dtype, a[k].shape, a[k].tobytes()) == (
            b[k].dtype, b[k].shape, b[k].tobytes()), k


@pytest.mark.parametrize('model_type', [GRU, CONFORMER])
def test_save_variables_npz_equals_sed_tpu_and_inverts_the_loader(
        model_type, tmp_path):
    """A port model's tree (``variables_from_model``) maps back onto its
    ``state_dict`` exactly; the port's writer and ``sed_tpu``'s write the
    same keys and bitwise the same arrays; the bench checkpoint loaded
    into a port model and exported again is that file, key for key and
    bit for bit (float16 -> float32 -> float16 is exact)."""
    from sed_tpu_torch.compat.bench_weights import seeded_model
    from sed_tpu_torch.compat.from_flax import load_npz
    model = load_npz(BENCH, GRU, CFG, 'cpu') if model_type == GRU else \
        seeded_model(model_type, CFG, seed=0)
    tree = from_flax.variables_from_model(model)
    back = from_flax.state_dict_from_variables(tree)
    for k, v in model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k
    ours, theirs = str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz')
    npz_ckpt.save_variables_npz(ours, tree)
    jax_npz.save_variables_npz(theirs, tree)
    _bitwise_same(_flat(ours), _flat(theirs))
    if model_type == GRU:
        _bitwise_same(_flat(ours), _flat(BENCH))


def test_exported_gru_serves_the_same_events_in_sed_tpu(tmp_path):
    """The bench GRU exported by the port: ``sed_tpu``'s engine serving
    the ``.npz`` gives the port engine's events and XML on 8 bench
    clips."""
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu.serve.engine import SedInferenceEngine as JaxEngine
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    path = str(tmp_path / 'gru.npz')
    npz_ckpt.save_variables_npz(path, from_flax.variables_from_model(
        load_npz(BENCH, GRU, CFG, 'cpu')))
    clips = learning.make_clips(8, CFG.sample_rate, seconds=5, seed=0)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    want = JaxEngine(jax_get_model(GRU, CFG),
                     jax_npz.load_variables_npz(path), CFG,
                     batch_size=8).predict_clips(pcm)
    got = SedInferenceEngine(load_npz(path, GRU, CFG, 'cpu'), CFG, 'cpu',
                             batch_size=8).predict_clips(pcm)
    assert sum(map(len, got[0])) > 0
    assert got == want


def test_exported_conformer_forward_equals_sed_tpu(tmp_path):
    """A seeded Conformer exported by the port: ``sed_tpu``'s model on the
    ``.npz`` gives the port's framewise and clipwise outputs within 1e-4
    (seeded weights leave probabilities at the thresholds, so events are
    not compared)."""
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu_torch.compat.bench_weights import seeded_model
    from sed_tpu_torch.compat.from_flax import load_npz
    path = str(tmp_path / 'conformer.npz')
    npz_ckpt.save_variables_npz(path, from_flax.variables_from_model(
        seeded_model(CONFORMER, CFG, seed=0)))
    wav = learning.make_clips(2, CFG.sample_rate, seconds=2, seed=4)
    want = jax_get_model(CONFORMER, CFG).apply(
        jax_npz.load_variables_npz(path), wav, train=False)
    with torch.no_grad():
        got = load_npz(path, CONFORMER, CFG, 'cpu')(torch.from_numpy(wav))
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4)


@pytest.mark.parametrize('seed', [0, 5])
def test_flax_init_draws_sed_tpus_fresh_model(seed):
    """``compat/flax_init`` draws ``sed_tpu``'s ``model.init`` under
    ``PRNGKey(seed)`` without JAX: every leaf bitwise but the GRU's
    recurrent weights, whose orthogonal n gate (numpy's QR and scipy's
    erfinv in place of XLA's) is within 1e-5; their uniform r and z gates
    are bitwise."""
    import jax
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu_torch.compat.flax_init import gru_frameatt_variables
    from sed_tpu_torch.models.registry import get_model
    want = jax_get_model(GRU, CFG).init(
        {'params': jax.random.PRNGKey(seed)},
        np.zeros((1, CFG.sample_rate), np.float32), train=False)
    want = npz_ckpt._flatten(jax.tree_util.tree_map(np.asarray, want))
    got = npz_ckpt._flatten(gru_frameatt_variables(
        from_flax.variables_from_model(get_model(GRU, CFG)), seed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        if k.endswith('w_hh'):
            h = got[k].shape[1]
            assert np.array_equal(got[k][:2 * h], want[k][:2 * h]), k
            np.testing.assert_allclose(got[k][2 * h:], want[k][2 * h:],
                                       rtol=0, atol=1e-5)
        else:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize('n,batch', [(7, 3), (5, 5), (4, 6)])
def test_samplers_with_a_row_count_equal_the_file_read(packed, n, batch):
    """``TrainSampler`` and ``TestSampler`` given ``audios_num`` give the
    stream they give when they count the file's rows themselves, and
    open no file: a path that does not exist is fine."""
    import h5py
    from sed_tpu_torch.data.dataset import TestSampler, TrainSampler
    path = os.path.join(packed[1], f'rows{n}.h5')
    with h5py.File(path, 'w') as hf:
        hf.create_dataset('audio_name', data=np.array(
            [f'{i}.wav'.encode() for i in range(n)], dtype='S80'))
    for sampler in (TrainSampler, TestSampler):
        read = iter(sampler(path, batch))
        given = iter(sampler(path, batch, audios_num=n))
        ghost = iter(sampler(path + '.absent', batch, audios_num=n))
        for _ in range(12 if sampler is TrainSampler else
                       -(-n // batch)):
            want = next(read)
            assert next(given) == want
            assert [m['index_in_hdf5'] for m in next(ghost)] == \
                [m['index_in_hdf5'] for m in want]
