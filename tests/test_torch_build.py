"""sed_tpu_torch/_build.py: the digest that names a built kernel library
covers every source under ``csrc/`` and the flags, so an edited header
is never served by a stale library, and a missing library is built
together with every other missing one.  No nvcc needed."""

import os
import threading
import types

import pytest

from sed_tpu_torch import _build


def _tree(tmp_path):
    csrc = tmp_path / 'csrc'
    (csrc / 'sub').mkdir(parents=True)
    (csrc / 'logmel.cu').write_text('#include "mma.cuh"\nint k;\n')
    (csrc / 'mma.cuh').write_text('// helpers\n')
    (csrc / 'sub' / 'deep.cuh').write_text('// more helpers\n')
    (csrc / 'README').write_text('not a source\n')
    return csrc


def test_digest_is_stable_when_nothing_changes(tmp_path):
    csrc = _tree(tmp_path)
    first = _build.source_digest(str(csrc))
    assert first == _build.source_digest(str(csrc))
    assert len(first) == 16


def test_digest_follows_headers_sources_and_flags(tmp_path):
    csrc = _tree(tmp_path)
    seen = {_build.source_digest(str(csrc))}
    (csrc / 'mma.cuh').write_text('// helpers, edited\n')
    seen.add(_build.source_digest(str(csrc)))
    (csrc / 'sub' / 'deep.cuh').write_text('// more helpers, edited\n')
    seen.add(_build.source_digest(str(csrc)))
    (csrc / 'logmel.cu').write_text('#include "mma.cuh"\nint k2;\n')
    seen.add(_build.source_digest(str(csrc)))
    (csrc / 'new.cuh').write_text('')
    seen.add(_build.source_digest(str(csrc)))
    seen.add(_build.source_digest(str(csrc), flags=('-O2',)))
    assert len(seen) == 6


def test_digest_ignores_files_that_are_not_sources(tmp_path):
    csrc = _tree(tmp_path)
    before = _build.source_digest(str(csrc))
    (csrc / 'README').write_text('edited\n')
    (csrc / 'notes.txt').write_text('new\n')
    assert _build.source_digest(str(csrc)) == before


def test_package_digest_covers_the_shipped_sources():
    names = sorted(f for f in os.listdir(_build.CSRC)
                   if f.endswith(('.cu', '.cuh')))
    assert 'logmel.cu' in names and 'mma_sm90.cuh' in names
    assert _build.source_digest() == _build.source_digest(_build.CSRC,
                                                          _build.NVCC_FLAGS)


def test_a_missing_library_builds_every_missing_one_at_once(tmp_path,
                                                            monkeypatch):
    """``load`` of a missing library compiles each missing library in a
    build of its own, all at the same time, and leaves a built one as it
    is; a failed build raises in the ``load`` of its own library only."""
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for name in ('built', 'one', 'two', 'bad'):
        (csrc / f'{name}.cu').write_text(f'// {name}\n')
    (csrc / 'helpers.cuh').write_text('// not a library\n')
    monkeypatch.setattr(_build, 'CSRC', str(csrc))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_build_seconds', {})
    monkeypatch.setattr(_build, '_build_errors', {})
    os.makedirs(_build.BUILD_DIR)
    open(_build.library_path('built'), 'w').close()
    together = threading.Barrier(2, timeout=30)
    compiled = []

    def compile_(name):
        compiled.append(name)
        if name == 'bad':
            raise RuntimeError('nvcc failed on bad.cu')
        together.wait()     # 'one' and 'two' build at once, or time out
        path = _build.library_path(name)
        with open(path + '.log', 'w') as f:
            f.write(f'ptxas {name}\n')
        open(path, 'w').close()
        return 4.5

    monkeypatch.setattr(_build, '_compile', compile_)
    monkeypatch.setattr(_build.ctypes, 'CDLL', lambda path: types.
                        SimpleNamespace(sed_cuda_error_string=types.
                                        SimpleNamespace()))
    one = _build.load.__wrapped__('one')
    assert sorted(compiled) == ['bad', 'one', 'two']
    assert (one.build_seconds, one.build_log) == (4.5, 'ptxas one\n')
    two = _build.load.__wrapped__('two')
    built = _build.load.__wrapped__('built')
    assert (two.build_seconds, built.build_seconds) == (4.5, 0.0)
    assert len(compiled) == 3
    with pytest.raises(RuntimeError, match='nvcc failed on bad.cu'):
        _build.load.__wrapped__('bad')
    assert compiled[3:] == ['bad']
