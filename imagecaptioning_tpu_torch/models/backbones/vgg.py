"""VGG16 trunk and classifier head — port of
`imagecaptioning_tpu/models/backbones/vgg.py`.

Both are `nn.Sequential`s indexed like torchvision's `vgg16.features` and
`vgg16.classifier`, so reference checkpoints (`features.{idx}`,
`classifier.0/.3`) load with `load_state_dict`. Images stay NHWC at the
interface. Inside, the convolutions run on cuDNN in `channels_last`
memory, so the trunk's NHWC output is a view with no copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# (out_channels per conv) per stage; maxpool after each stage.
VGG16_STAGES: Sequence[Sequence[int]] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


class VGGFeatures(nn.Sequential):
    """VGG16 conv trunk over the first `end_stage` stages: 3×3 convs with
    padding 1 and ReLU, 2×2/2 max-pool after every stage except the fifth
    unless `include_final_pool`. NHWC in, NHWC out."""

    def __init__(self, include_final_pool: bool = False, end_stage: int = 5):
        layers = []
        in_ch = 3
        for stage in range(end_stage):
            for ch in VGG16_STAGES[stage]:
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1),
                           nn.ReLU(inplace=True)]
                in_ch = ch
            if stage < len(VGG16_STAGES) - 1 or include_final_pool:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.out_channels = in_ch
        # weights in channels_last too, so cuDNN converts nothing per call
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self[0].weight.dtype
        # NHWC → an NCHW view in channels_last memory (no copy when x is
        # contiguous NHWC); back to an NHWC view at the end
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        return super().forward(x).permute(0, 2, 3, 1)


class VGGClassifierHead(nn.Sequential):
    """torchvision `vgg16.classifier[:-1]`: fc6 (25088→4096) → ReLU →
    dropout → fc7 (4096→4096) → ReLU. Its input is the pooled code
    flattened in CHW order, the reference's layout."""

    def __init__(self, in_features: int = 25088, dropout: float = 0.5):
        super().__init__(nn.Linear(in_features, 4096), nn.ReLU(inplace=True),
                         nn.Dropout(dropout), nn.Linear(4096, 4096),
                         nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self[0].weight.dtype))
