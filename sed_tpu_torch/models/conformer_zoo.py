"""Conformer-family SED models and the token-pooling Conformers
(counterpart of ``sed_tpu/models/conformer_zoo.py``).

* ``ConformerSed``: ConvBlock stack -> mean over mel bins -> Conformer
  (512 -> 144, 3 layers, 4 heads, kernel 7) or ESPnet Transformer
  (conv2d-subsampling input) encoder -> attention head ('att') or
  per-frame sigmoid classifier ('avg'), interpolated x8 (4 blocks) or
  x(1000 // T') (6 blocks) and padded to the next multiple of 100 frames.
* ``TokenPoolingConformer``: a learned tag token is prepended to the
  frame sequence; the encoder's output at the token is the clipwise
  LOGIT vector, the rest are frame LOGITS (for the ``*_logits`` losses).
  Backbone 'baseline' (``Cnn_7layers_Conformer``) is the DCASE baseline
  CNN, time / 8, interpolated x8.  Backbone 'convblocks'
  (``Cnn_9layers_Conformer``) FLATTENS time x freq of the ConvBlock
  output into the token sequence, time-major and freq-minor (a 10 s clip
  gives 125 * 8 = 1000 tokens), and ships them uninterpolated: the
  reference's behaviour, kept.

Submodule names follow the flax parameter tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sed_tpu_torch.models import blocks, encoders
from sed_tpu_torch.models.base import SedFeatureBase

CONFORMER_KW = dict(adim=144, aheads=4, dropout_rate=0.1, elayers=3,
                    eunits=576, kernel_size=7)
TRANSFORMER_KW = dict(adim=144, aheads=4, dropout_rate=0.1, elayers=3,
                      eunits=576, transformer_input_layer='conv2d',
                      transformer_attn_dropout_rate=0.0, after_conv=False)


def _make_encoder(encoder_type: str, idim: int, **transformer_kw):
    if encoder_type == 'Conformer':
        return encoders.ConformerEncoder(idim=idim, **CONFORMER_KW)
    if encoder_type == 'Transformer':
        return encoders.TransformerEncoder(
            idim=idim, **dict(TRANSFORMER_KW, **transformer_kw))
    raise ValueError(f'unknown encoder_type: {encoder_type}')


class _ConvBlockStack(SedFeatureBase):
    """The shared preamble + ``conv_block1..N`` (the last one unpooled)."""

    def __init__(self, cfg, feature_type: str,
                 conv_channels: Sequence[int], compute_dtype=None):
        super().__init__(cfg, feature_type, compute_dtype=compute_dtype)
        self.conv_channels = tuple(conv_channels)
        in_ch = 1
        for i, ch in enumerate(self.conv_channels):
            self.add_module(f'conv_block{i + 1}', blocks.ConvBlock(in_ch, ch))
            in_ch = ch

    def conv_stack(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.conv_channels) - 1
        for i in range(len(self.conv_channels)):
            x = getattr(self, f'conv_block{i + 1}')(
                x, pool_size=(1, 1) if i == last else (2, 2),
                pool_type='avg')
        return x


class ConformerSed(_ConvBlockStack):
    """ConvBlock stack + Conformer/Transformer encoder + att/avg head."""

    reference_unused = ('classifier', 'linear_emb')

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel',
                 conv_channels: Sequence[int] = (64, 128, 256, 512),
                 encoder_type: str = 'Conformer', head: str = 'att',
                 compute_dtype=None):
        super().__init__(cfg, feature_type, conv_channels, compute_dtype)
        if head not in ('att', 'avg'):
            raise ValueError(f'unknown head: {head}')
        self.head = head
        self.encoder = _make_encoder(encoder_type, self.conv_channels[-1])
        adim = CONFORMER_KW['adim']
        if head == 'att':
            self.att_block = blocks.AttBlock(adim, classes_num,
                                             activation='sigmoid')
        else:
            self.fc = nn.Linear(adim, classes_num)

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        x = self.compute_features(wav, mixup_lambda, timeshift,
                                  spec_augment, generator)
        x = self.conv_stack(x)
        x = torch.mean(x, dim=3).transpose(1, 2)             # (B, T', C)
        x, _ = self.encoder(x, None, generator)
        # 4 blocks: the fixed x8; 6 blocks: 1000 // T'
        ratio = 8 if len(self.conv_channels) == 4 \
            else max(1, 1000 // x.shape[1])

        if self.head == 'att':
            clipwise, _, cla = self.att_block(x)
            framewise = blocks.interpolate(cla, ratio)
            embedding = cla
        else:
            framewise = blocks.interpolate(torch.sigmoid(self.fc(x)), ratio)
            embedding = x
        if framewise.shape[1] != 1000:
            framewise = blocks.pad_framewise_output(
                framewise, blocks.roundup(framewise.shape[1]))
        if self.head == 'avg':
            clipwise = torch.mean(framewise, dim=1)

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}


_BASELINE_KW = dict(
    activation='Relu', conv_dropout=0.1, kernel_size=(3,) * 7,
    padding=(1,) * 7, stride=(1,) * 7,
    nb_filters=(16, 32, 64, 128, 128, 128, 128),
    pooling=((2, 2), (2, 2), (2, 2), (1, 2), (1, 2), (1, 2), (1, 1)))


class TokenPoolingConformer(_ConvBlockStack):
    """Tag-token pooling over a baseline-CNN or ConvBlock backbone; the
    outputs are logits."""

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel', backbone: str = 'baseline',
                 encoder_type: str = 'Conformer', interpolate_ratio: int = 8,
                 compute_dtype=None):
        if backbone not in ('baseline', 'convblocks'):
            raise ValueError(f'unknown backbone: {backbone}')
        super().__init__(cfg, feature_type,
                         (64, 128, 256, 512) if backbone == 'convblocks'
                         else (), compute_dtype)
        self.backbone = backbone
        self.interpolate_ratio = interpolate_ratio
        if backbone == 'baseline':
            self.cnn = encoders.BaselineCNN(in_channels=1, **_BASELINE_KW)
            input_dim = 128
        else:
            input_dim = 512
        self.linear_emb = nn.Linear(1, input_dim)
        self.encoder = _make_encoder(encoder_type, input_dim,
                                     transformer_input_layer='linear')
        self.classifier = nn.Linear(CONFORMER_KW['adim'], classes_num)

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        x = self.compute_features(wav, mixup_lambda, timeshift,
                                  spec_augment, generator)
        if self.backbone == 'baseline':
            x = self.cnn(x, generator)                       # (B,128,T/8,1)
            x = torch.mean(x, dim=3).transpose(1, 2)
        else:
            x = self.conv_stack(x)                           # (B,512,T',F')
            # time x freq flattened into the tokens, time-major
            x = x.flatten(2).transpose(1, 2)                 # (B,T'*F',512)

        tag = self.linear_emb(x.new_ones((x.shape[0], 1, 1)))
        x, _ = self.encoder(torch.cat([tag, x], dim=1), None, generator)

        x = self.classifier(x)
        weak, strong = x[:, 0, :], x[:, 1:, :]
        if self.interpolate_ratio > 1:
            strong = blocks.interpolate(strong, self.interpolate_ratio)
        return {'framewise_output': strong,
                'clipwise_output': weak,
                'embedding': strong}
