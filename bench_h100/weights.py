"""Model tensors for both sides of a run, made by the benchmark: the
repository's trained checkpoint mapped onto the program's ``state_dict``
names, or a seeded draw on the card.  The program's model and the plain
reference are given the same tensors; neither side makes its own.

Checkpoint layout (flax): conv kernels HWIO, Dense kernels (in, out),
BatchNorm scale/bias and mean/var, ``gru/{fw,bw}/{w_ih,w_hh,b_ih,b_hh}``
in the (r, z, n) gate order that ``nn.GRU`` uses too.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools', 'bench_checkpoint.npz')
_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}
_GRU = {'w_ih': 'weight_ih_l0', 'w_hh': 'weight_hh_l0', 'b_ih': 'bias_ih_l0',
        'b_hh': 'bias_hh_l0'}


def _name(key: str, leaf: np.ndarray) -> tuple:
    """(state_dict name, array in torch layout) of one checkpoint leaf."""
    _, *mods, last = key.split('/')
    if mods[0] == 'gru':
        return (f'gru.{_GRU[last]}' + ('_reverse' if mods[1] == 'bw' else ''),
                leaf)
    if last == 'kernel':
        leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
        return '.'.join(mods + ['weight']), leaf
    return '.'.join(mods + [_BN.get(last, last)]), leaf


def checkpoint(device, keep=None) -> dict:
    """The trained checkpoint's tensors (float32 on ``device``), those of
    the top-level modules in ``keep`` when it is given."""
    out = {}
    with np.load(CHECKPOINT) as npz:
        for key in npz.files:
            if keep is not None and key.split('/')[1] not in keep:
                continue
            name, leaf = _name(key, npz[key])
            out[name] = torch.from_numpy(
                np.ascontiguousarray(leaf, np.float32)).to(device)
    return out


def _fan(shape) -> tuple:
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def seeded(config: dict, seed: int, device, temporal) -> dict:
    """A fresh model drawn on ``device`` from ``seed``, in two calls (one
    uniform, one normal buffer), with the reference's distributions:
    Xavier-uniform convolutions and head, BatchNorm scale 1, bias 0,
    running mean 0, var 1, and the temporal block's leaves as
    ``temporal(config, d)`` states them for the conv stack's width ``d``:
    (its output width, {name: (law, shape, scale)}), the law ``uniform``
    (scale: the bound), ``normal`` (scale: the deviation) or ``zeros``,
    in the order they are drawn."""
    shapes, bounds, normal = {}, {}, {}
    cin = 1
    for i, c in enumerate(config['conv_channels']):
        for j, (a, b) in enumerate(((cin, c), (c, c)), 1):
            key = f'conv_block{i + 1}.conv{j}.weight'
            shapes[key] = (b, a, 3, 3)
            fi, fo = _fan(shapes[key])
            bounds[key] = math.sqrt(6.0 / (fi + fo))
        cin = c
    d, leaves = temporal(config, cin)
    zeros = {}
    for key, (law, shape, scale) in leaves.items():
        if law == 'zeros':
            zeros[key] = shape
            continue
        shapes[key] = shape
        {'uniform': bounds, 'normal': normal}[law][key] = scale
    classes = len(config['classes'])
    for n in ('att', 'cla'):
        shapes[f'att_block.{n}.weight'] = (classes, d)
        fi, fo = _fan((classes, d))
        bounds[f'att_block.{n}.weight'] = math.sqrt(6.0 / (fi + fo))

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    uni = [k for k in shapes if k in bounds]
    u = torch.rand(sum(math.prod(shapes[k]) for k in uni), generator=gen,
                   device=device)
    for k, part in zip(uni, u.split([math.prod(shapes[k]) for k in uni])):
        out[k] = ((part * 2.0 - 1.0) * bounds[k]).view(shapes[k])
    if normal:
        nrm = [k for k in shapes if k in normal]
        z = torch.randn(sum(math.prod(shapes[k]) for k in nrm),
                        generator=gen, device=device)
        for k, part in zip(nrm, z.split([math.prod(shapes[k])
                                         for k in nrm])):
            out[k] = (part * normal[k]).view(shapes[k])
    out.update({k: torch.zeros(s, device=device) for k, s in zeros.items()})
    bns = [('bn0', config['audio']['mel_bins'])] + [
        (f'conv_block{i + 1}.bn{j}', c)
        for i, c in enumerate(config['conv_channels']) for j in (1, 2)]
    for name, c in bns:
        out[f'{name}.weight'] = torch.ones(c, device=device)
        out[f'{name}.running_var'] = torch.ones(c, device=device)
        out[f'{name}.bias'] = torch.zeros(c, device=device)
        out[f'{name}.running_mean'] = torch.zeros(c, device=device)
    for n in ('att', 'cla'):
        out[f'att_block.{n}.bias'] = torch.zeros(classes, device=device)
    return out


def load_into(model: torch.nn.Module, tensors: dict) -> torch.nn.Module:
    """Copy ``tensors`` into the program's model: every parameter and
    buffer but the BatchNorm batch counters must be given."""
    missing, unexpected = model.load_state_dict(
        {k: v.clone() for k, v in tensors.items()}, strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise RuntimeError(f'weights: missing {missing}, unexpected '
                           f'{unexpected}')
    return model
