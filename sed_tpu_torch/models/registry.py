"""Model registry: reference ``model_type`` strings -> constructors
(counterpart of ``sed_tpu/models/registry.py``).

Only the ``CnnSed`` entries without a ``MultiHead`` are ported; any other
name raises ``KeyError`` listing the ported ones.
"""

from __future__ import annotations

from typing import Callable, Dict

from sed_tpu_torch.models.zoo import CnnSed

MODEL_REGISTRY: Dict[str, Callable] = {}


def register(name: str, **kwargs):
    def ctor(cfg, classes_num: int = 25, feature_type: str = 'logmel',
             **extra):
        merged = dict(kwargs)
        merged.update(extra)
        return CnnSed(cfg, classes_num=classes_num,
                      feature_type=feature_type, **merged)
    MODEL_REGISTRY[name] = ctor
    return ctor


# 9-layer CNN family
register('Cnn_9layers_FrameMax', temporal='none', head='max')
register('Cnn_9layers_FrameAvg', temporal='none', head='avg')
register('Cnn_9layers_FrameAtt', temporal='none', head='att')

# CNN + BiGRU family
register('Cnn_9layers_Gru_FrameAvg', temporal='gru', head='avg',
         gru_hidden=256)
register('Cnn_9layers_Gru_FrameAtt', temporal='gru', head='att',
         gru_hidden=256, pad_to_roundup=True)
register('Cnn_14layers_Gru_FrameAtt', temporal='gru', head='att',
         conv_channels=(64, 128, 256, 512, 1024, 2048), gru_hidden=1024,
         pad_to_roundup=True)
# regression clone of Gru_FrameAtt whose reference leaves the pad out
register('Cnn_9layers_Gru_Reg', temporal='gru', head='att',
         gru_hidden=256, pad_to_roundup=False)


def get_model(model_type: str, cfg, classes_num: int = 25,
              feature_type: str = 'logmel', **kwargs) -> CnnSed:
    """Instantiate a model by its reference name (on the CPU, in eval
    mode; move it with ``.to(device)``)."""
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f'model_type {model_type!r} is not ported to sed_tpu_torch; '
            f'ported: {sorted(MODEL_REGISTRY)}')
    return MODEL_REGISTRY[model_type](
        cfg, classes_num=classes_num, feature_type=feature_type,
        **kwargs).eval()
