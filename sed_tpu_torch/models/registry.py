"""Model registry: reference ``model_type`` strings -> constructors
(counterpart of ``sed_tpu/models/registry.py``).

``MODEL_REGISTRY`` holds all of ``sed_tpu``'s names: the ``CnnSed``
entries (CNN, CNN + BiGRU, CNN + single-block Transformer), the Conformer
family and its token-pooling variants, VGGish and PANNs CNN14.
``PORT_REGISTRY`` holds the models the port runs that ``sed_tpu`` has
no counterpart of: HTS-AT (``HTSAT_Swin_Transformer``, eval only).
``get_model`` builds a name of either.  ``cls`` picks the model class of
an entry (default ``CnnSed``).
"""

from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from sed_tpu_torch.models.conformer_zoo import (ConformerSed,
                                                TokenPoolingConformer)
from sed_tpu_torch.models.htsat import HtsatSed
from sed_tpu_torch.models.panns import Cnn14DecisionLevelAtt
from sed_tpu_torch.models.vggish import VGGishSed
from sed_tpu_torch.models.zoo import CnnSed

MODEL_REGISTRY: Dict[str, Callable] = {}


def register(name: str, **kwargs):
    def ctor(cfg, classes_num: int = 25, feature_type: str = 'logmel',
             **extra):
        merged = dict(kwargs)
        merged.update(extra)
        return merged.pop('cls', CnnSed)(
            cfg, classes_num=classes_num, feature_type=feature_type,
            **merged)
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

# CNN + single-block Transformer family; the 9-layer entries keep the
# raw interpolated length (496 frames for a 5 s clip)
register('Cnn_9layers_Transformer_FrameAvg', temporal='multihead',
         head='avg')
register('Cnn_9layers_Transformer_FrameAtt', temporal='multihead',
         head='att')
register('Cnn_14layers_Transformer_FrameAtt', temporal='multihead',
         head='att', conv_channels=(64, 128, 256, 512, 1024, 2048),
         pad_to_roundup=True)

# CNN + Conformer family, and the token-pooling Conformers (logit outputs)
register('Cnn_9layers_Conformer_FrameAtt', cls=ConformerSed, head='att',
         encoder_type='Conformer')
register('Cnn_9layers_Conformer_FrameAvg', cls=ConformerSed, head='avg',
         encoder_type='Conformer')
register('Cnn_14layers_Conformer_FrameAtt', cls=ConformerSed, head='att',
         encoder_type='Conformer',
         conv_channels=(64, 128, 256, 512, 1024, 2048))
register('Cnn_7layers_Conformer', cls=TokenPoolingConformer,
         backbone='baseline', encoder_type='Conformer', interpolate_ratio=8)
register('Cnn_9layers_Conformer', cls=TokenPoolingConformer,
         backbone='convblocks', encoder_type='Conformer',
         interpolate_ratio=0)

# VGGish transfer-learning family
register('VGGish_FrameAtt', cls=VGGishSed, head='att')
register('VGGish_Gru_FrameAtt', cls=VGGishSed, head='gru_att')
register('VGGish_FrameAvg', cls=VGGishSed, head='avg')

# PANNs CNN14
register('Cnn14_DecisionLevelAtt', cls=Cnn14DecisionLevelAtt)

# the port's own models, with no sed_tpu counterpart
PORT_REGISTRY: Dict[str, Callable] = {'HTSAT_Swin_Transformer': HtsatSed}


def get_model(model_type: str, cfg, classes_num: int = 25,
              feature_type: str = 'logmel', **kwargs) -> nn.Module:
    """Instantiate a model by its reference name (on the CPU, in eval
    mode; move it with ``.to(device)``).  ``compute_dtype=torch.bfloat16``
    runs a ``CnnSed``'s conv stack in bf16 (the other families keep
    float32 convolutions, as in ``sed_tpu``)."""
    ctor = MODEL_REGISTRY.get(model_type, PORT_REGISTRY.get(model_type))
    if ctor is None:
        raise KeyError(
            f'unknown model_type {model_type!r}; available: '
            f'{sorted(MODEL_REGISTRY) + sorted(PORT_REGISTRY)}')
    return ctor(
        cfg, classes_num=classes_num, feature_type=feature_type,
        **kwargs).eval()
