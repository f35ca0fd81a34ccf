"""sed_tpu_torch/_build.py: the digest that names a built kernel library
covers every source under ``csrc/`` and the flags, so an edited header
is never served by a stale library.  No nvcc needed."""

import os

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
