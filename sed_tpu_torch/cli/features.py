"""Feature packing CLI (a copy of ``sed_tpu/cli/features.py``,
``utils/features.py:386-399``).  Host-only: numpy and h5py, no device.

``pack_audio_files_to_hdf5``: wav dir + metadata csv -> packed HDF5 under
``<workspace>/hdf5s/{data_type}_{feature_type}_{quality}.h5``.
"""

from __future__ import annotations

import argparse
import os

from sed_tpu_torch.config import get_audio_config
from sed_tpu_torch.data import metadata
from sed_tpu_torch.data.hdf5_pack import (hdf5_filename,
                                          pack_audio_files_to_hdf5)


def pack(args):
    cfg = get_audio_config(audio_8k=args.audio_8k, audio_16k=args.audio_16k)
    csv_path = os.path.join(args.dataset_dir, 'metadata',
                            metadata.get_weak_csv_filename(args.data_type))
    strong_csv = None
    if args.data_type in ('strong_training', 'strong_validation', 'testing'):
        # strong frame labels exist for these splits
        # (``utils/features.py:328-341``)
        name = ('groundtruth_strong_label_testing_set.csv'
                if args.data_type == 'testing' else
                f'groundtruth_strong_label_{args.data_type}_set.csv')
        sub = '' if args.data_type == 'testing' else 'strong'
        candidate = os.path.join(args.dataset_dir, 'metadata', sub, name)
        if os.path.isfile(candidate):
            strong_csv = candidate

    if args.audio_8k:
        audios_dir = os.path.join(args.dataset_dir, args.data_type, '8k')
    else:
        audios_dir = os.path.join(args.dataset_dir, args.data_type)

    out = os.path.join(
        args.workspace, 'hdf5s',
        hdf5_filename(args.data_type, args.feature_type, cfg.name,
                      args.mini_data))
    pack_audio_files_to_hdf5(
        audios_dir=audios_dir, csv_path=csv_path, packed_hdf5_path=out,
        data_type=args.data_type, cfg=cfg, feature_type=args.feature_type,
        strong_csv_path=strong_csv, mini_data=args.mini_data)
    print('packed to', out)
    return out


def get_parser():
    parser = argparse.ArgumentParser(description='sed_tpu_torch features')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('pack_audio_files_to_hdf5')
    sub.add_argument('--dataset_dir', type=str, required=True)
    sub.add_argument('--workspace', type=str, required=True)
    sub.add_argument('--data_type', type=str, required=True,
                     choices=['training', 'testing', 'evaluation',
                              'weak_training', 'strong_training',
                              'strong_validation', 'strong_fsd50k'])
    sub.add_argument('--feature_type', type=str, default='logmel',
                     choices=['logmel', 'gamma'])
    sub.add_argument('--audio_8k', action='store_true', default=False)
    sub.add_argument('--audio_16k', action='store_true', default=False)
    sub.add_argument('--mini_data', action='store_true', default=False)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    pack(args)


if __name__ == '__main__':
    main()
