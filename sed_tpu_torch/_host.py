"""The numpy-only host modules of ``sed_tpu``, shared with the port.

These modules import no JAX, so the port reuses them instead of forking
them: one source of truth for labels, thresholds, event decoding, XML,
audio I/O and the .npz checkpoint format.

``sed_tpu/dsp/filters.py`` is numpy-only too, but its package
``__init__`` imports the JAX frontend, so it is loaded here by file path.
Its ``frontend_arrays`` stays the one source of the DFT and mel
matrices for both packages.
"""

from __future__ import annotations

import importlib.util
import os

from sed_tpu import config
from sed_tpu.cli import common as cli_common
from sed_tpu.data import audio_io
from sed_tpu.native import vad_native
from sed_tpu.post import events, merge, vad, xml_writer
from sed_tpu.utils import npz_ckpt


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


filters = _load_by_path(
    'sed_tpu_torch._filters',
    os.path.join(os.path.dirname(config.__file__), 'dsp', 'filters.py'))

__all__ = ['audio_io', 'cli_common', 'config', 'events', 'filters', 'merge',
           'npz_ckpt', 'vad', 'vad_native', 'xml_writer']
