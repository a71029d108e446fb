"""VGG16 trunk and classifier head — port of
`imagecaptioning_tpu/models/backbones/vgg.py`.

Both are `nn.Sequential`s indexed like torchvision's `vgg16.features` and
`vgg16.classifier`, so reference checkpoints (`features.{idx}`,
`classifier.0/.3`) load with `load_state_dict`. Images stay NHWC at the
interface. Inside, the convolutions run on cuDNN in `channels_last`
memory, so the trunk's NHWC output is a view with no copy.

Both compute in `compute_dtype` whatever their parameters' dtype, as
flax's `dtype=` does beside its `param_dtype`: each call casts the
weights to it (a no-op where they are stored in it, as serving stores
them), so training keeps fp32 master parameters and their gradients
arrive in fp32 through the cast. (Adam at lr 1e-5 on bf16-stored
weights would round most updates away: a bf16 ulp is ~0.4 % of the
weight.) `compute_dtype=None` computes in the parameters' own dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.parallel import mesh

# (out_channels per conv) per stage; maxpool after each stage.
VGG16_STAGES: Sequence[Sequence[int]] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


class VGGFeatures(nn.Sequential):
    """VGG16 conv trunk over the first `end_stage` stages: 3×3 convs with
    padding 1 and ReLU, 2×2/2 max-pool after every stage except the fifth
    unless `include_final_pool`. NHWC in, NHWC out."""

    def __init__(self, include_final_pool: bool = False, end_stage: int = 5,
                 compute_dtype: Optional[torch.dtype] = None):
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
        self.compute_dtype = compute_dtype
        # weights in channels_last too, so cuDNN converts nothing per call
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self[0].weight.dtype
        # NHWC → an NCHW view in channels_last memory (no copy when x is
        # contiguous NHWC); back to an NHWC view at the end
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                # the ReLU after it may work in place: a convolution's
                # backward needs its input, not its output
                x = F.conv2d(x, layer.weight.to(dtype), layer.bias.to(dtype),
                             padding=layer.padding)
            else:
                x = layer(x)
        return x.permute(0, 2, 3, 1)


class VGGClassifierHead(nn.Sequential):
    """torchvision `vgg16.classifier[:-1]`: fc6 (25088→4096) → ReLU →
    dropout → fc7 (4096→4096) → ReLU. Its input is the pooled code
    flattened in CHW order, the reference's layout. Dropout acts only when
    `train`, with its mask drawn from `generator` (flax's
    `deterministic=not train`)."""

    def __init__(self, in_features: int = 25088, dropout: float = 0.5,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(nn.Linear(in_features, 4096), nn.ReLU(inplace=True),
                         nn.Dropout(dropout), nn.Linear(4096, 4096),
                         nn.ReLU(inplace=True))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fc6, _, drop, fc7, _ = self
        dtype = self.compute_dtype or fc6.weight.dtype
        x = F.relu(F.linear(x.to(dtype), fc6.weight.to(dtype),
                            fc6.bias.to(dtype)), inplace=True)
        if train and drop.p > 0:
            keep = 1.0 - drop.p
            mask = mesh.current().bernoulli(x, keep, generator)
            x = x * mask / keep
        return F.relu(F.linear(x, fc7.weight.to(dtype), fc7.bias.to(dtype)),
                      inplace=True)
