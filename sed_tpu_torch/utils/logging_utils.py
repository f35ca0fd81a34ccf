"""Logging setup (``utils/utilities.py:29-63``): ``create_logging`` is a
copy of ``sed_tpu/utils/logging_utils.py``'s; ``count_parameters`` takes
an ``nn.Module``."""

from __future__ import annotations

import logging
import os


def get_filename(path: str) -> str:
    name_ext = os.path.realpath(path).split('/')[-1]
    return os.path.splitext(name_ext)[0]


def count_parameters(model) -> int:
    """Log a per-parameter count table of an ``nn.Module`` and return the
    total (``utils/utilities.py:17-27``'s PrettyTable, dependency-free;
    the table of ``sed_tpu``'s, with the port's parameter names)."""
    rows = [(name, p.numel()) for name, p in model.named_parameters()
            if p.requires_grad]
    width = max([len(r[0]) for r in rows] + [len('Module')])
    sep = '+' + '-' * (width + 2) + '+' + '-' * 12 + '+'
    logging.info(sep)
    logging.info('| %-*s | %10s |', width, 'Module', 'Parameters')
    logging.info(sep)
    for name, n in rows:
        logging.info('| %-*s | %10d |', width, name, n)
    total = sum(n for _, n in rows)
    logging.info(sep)
    logging.info('Total trainable parameters: %d', total)
    return total


def create_logging(log_dir: str, filemode: str = 'w') -> logging.Logger:
    """File + console logging with sequentially numbered log files."""
    os.makedirs(log_dir, exist_ok=True)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f'{i:04d}.log')):
        i += 1
    log_path = os.path.join(log_dir, f'{i:04d}.log')
    logging.basicConfig(
        level=logging.DEBUG,
        format=('%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s '
                '%(message)s'),
        datefmt='%a, %d %b %Y %H:%M:%S',
        filename=log_path,
        filemode=filemode,
        force=True)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(
        logging.Formatter('%(name)-12s: %(levelname)-8s %(message)s'))
    logging.getLogger('').addHandler(console)
    # keep framework debug out of the root DEBUG stream
    for noisy in ('jax', 'jax._src', 'orbax', 'absl', 'h5py'):
        logging.getLogger(noisy).setLevel(logging.INFO)
    return logging
