"""Weights for the models the repo has no trained checkpoint of.

``transformer_variables`` makes ``Cnn_9layers_Transformer_FrameAtt``'s
with numpy alone; ``seeded_model`` makes any registry model's from the
port's own ``init_weights`` under a CPU ``torch.Generator`` (the same
weights for every device), with the trained bench conv stack where the
family shares it.

The repo's trained checkpoint, ``tools/bench_checkpoint.npz``, is a
``Cnn_9layers_Gru_FrameAtt``.  Its ``bn0``, ``conv_block1-4`` and
``att_block`` leaves have the Transformer model's shapes (the attention
head takes 512 inputs: the GRU's 2 x 256 and the MultiHead's d_model
alike), so they are kept; the ``multihead`` leaves are drawn from a
seed with flax's init distributions (``sed_tpu/models/blocks.py``
``MultiHead``): normal noise of std sqrt(2 / (d_model + 64)) for the
q/k/v kernels, Xavier-normal (flax's truncated form) for ``fc``, zero
biases.  The tree is in flax layout, so ``sed_tpu``'s model and the
port take the same one.
"""

from __future__ import annotations

import os

import numpy as np

from sed_tpu_torch.utils import npz_ckpt

BENCH_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'tools', 'bench_checkpoint.npz')

_KEPT = ('bn0', 'conv_block1', 'conv_block2', 'conv_block3', 'conv_block4',
         'att_block')
# flax truncated_normal: +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.RandomState, shape, std: float):
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x * (std / _TRUNC_STD)


def transformer_variables(seed: int = 0) -> dict:
    """Flax-layout variables of ``Cnn_9layers_Transformer_FrameAtt``."""
    bench = npz_ckpt.load_variables_npz(BENCH_CHECKPOINT)
    rng = np.random.RandomState(seed)
    d_model, d_k = 512, 64
    width = 8 * d_k                                 # 8 heads
    qkv_std = np.sqrt(2.0 / (d_model + d_k))
    multihead = {
        name: {'kernel': (rng.standard_normal((d_model, width)) * qkv_std
                          ).astype(np.float32),
               'bias': np.zeros(width, np.float32)}
        for name in ('w_qs', 'w_ks', 'w_vs')}
    multihead['fc'] = {
        'kernel': _truncated_normal(rng, (width, d_model),
                                    np.sqrt(2.0 / (width + d_model))
                                    ).astype(np.float32),
        'bias': np.zeros(d_model, np.float32)}
    params = {k: bench['params'][k] for k in _KEPT}
    params['multihead'] = multihead
    stats = {k: v for k, v in bench['batch_stats'].items() if k in _KEPT}
    return {'params': params, 'batch_stats': stats}


def seeded_model(model_type: str, cfg, seed: int = 0):
    """A registry model on the CPU, in eval mode, with seeded weights.

    Every tensor is drawn by ``models/blocks.init_weights`` from
    ``torch.Generator().manual_seed(seed)`` on the CPU (``sed_tpu``'s
    distributions, not its draws).  Where the model has the bench
    checkpoint's 4-block conv stack (``ConformerSed`` with 4 blocks, the
    'convblocks' ``TokenPoolingConformer``) its ``bn0`` and
    ``conv_block1-4`` tensors are the trained ones, so the encoder sees
    realistic features; the other families (6-block stacks, the baseline
    CNN, VGGish, CNN14) stay as drawn."""
    import torch
    from sed_tpu_torch.compat.from_flax import state_dict_from_variables
    from sed_tpu_torch.models.blocks import init_weights
    from sed_tpu_torch.models.registry import get_model
    model = init_weights(get_model(model_type, cfg),
                         torch.Generator().manual_seed(seed))
    if getattr(model, 'conv_channels', None) == (64, 128, 256, 512) \
            and getattr(model, 'bn0', None) is not None:
        bench = npz_ckpt.load_variables_npz(BENCH_CHECKPOINT)
        kept = _KEPT[:-1]                               # without att_block
        state = state_dict_from_variables({
            'params': {k: bench['params'][k] for k in kept},
            'batch_stats': {k: bench['batch_stats'][k] for k in kept}})
        _, unexpected = model.load_state_dict(state, strict=False)
        assert not unexpected, unexpected
    return model.eval()
