"""ResNet feature trunk — port of
`imagecaptioning_tpu/models/backbones/resnet.py` (`Bottleneck`,
`ResNetFeatures`, `resnet101_features`, `resnet50_features`).

The reference encoder is torchvision's `resnet101(IMAGENET1K_V2)` without
its pool and classifier, `nn.Sequential(*resnet.children())[:-2]`
(`AlexCap/LSTMModel.py:23-27`): a (B, 2048, 7, 7) map at 224². This module
is that Sequential, numbered as it numbers the children (`0` conv1, `1`
bn1, `2` relu, `3` maxpool, `4`–`7` layer1–4, each block with `conv1-3`,
`bn1-3` and, on a stage's first block, `downsample.0/.1`), so a reference
`LSTMModel.state_dict()` loads into it. Stride sits on each block's 3×3
convolution and its projection shortcut.

Images are NHWC at the interface, as in the JAX package; inside, cuDNN
convolves in `channels_last` memory. The convolutions compute in
`compute_dtype` over weights of any dtype, cast each call (fp32 master
weights under bf16 compute, the VGG trunk's idiom).

BatchNorm is flax's `BatchNorm(momentum=0.9, epsilon=1e-5)`:
- `train=False`: the running statistics;
- `train=True`: the batch's mean and BIASED variance normalise the
  output, and the running statistics move by `0.9 · running + 0.1 ·
  batch`, the biased variance included (torch's own update takes the
  unbiased one, so the port rescales torch's share of the update).
The statistics and the normalisation are fp32 (fp64 for fp64 input); the
output is in the input's dtype. In a data-parallel step the training
statistics are the global batch's, as under GSPMD: two sums over the data
ranks (`parallel.mesh.batch_norm_train`) that autograd reduces back, and
the running statistics move by the global batch's mean and biased
variance, the same on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.parallel import mesh

BN_MOMENTUM = 0.9     # flax's: the weight of the running statistics
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (its parameters and buffers, hence the
    reference's keys) with flax's training semantics (module docstring).
    `num_batches_tracked` counts the training calls, as torch's does."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dp = mesh.current()
        if dp.size > 1:
            out, mean, var = mesh.batch_norm_train(x, self.weight, self.bias,
                                                   self.eps, dp)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                        self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype),
                                       self.momentum)
                self.num_batches_tracked.add_(1)
            return out
        # torch moves running_var by the unbiased variance v·n/(n-1);
        # rescale its share of the update (C values) rather than reduce
        # the activations a second time: rv = m·rv0 + (rv' − m·rv0)·(n−1)/n.
        # batch_norm keeps the running_var it is given for its backward,
        # so it gets a copy.
        kept = BN_MOMENTUM * self.running_var
        moved = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, moved, self.weight,
                           self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            torch.lerp(kept, moved, (n - 1) / n, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return out


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    return F.conv2d(x, conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride) → 1×1 expand ×4, with a projection
    shortcut (`downsample`) on the first block of each stage."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
            BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype):
        out = F.relu(self.bn1(_conv(self.conv1, x, dtype), train))
        out = F.relu(self.bn2(_conv(self.conv2, out, dtype), train))
        out = self.bn3(_conv(self.conv3, out, dtype), train)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(_conv(conv, x, dtype), train)
        return F.relu(out + identity)


class ResNetFeatures(nn.Sequential):
    """ResNet-{50,101,152} trunk up to and including layer4 (the
    reference's `children()[:-2]`): NHWC images in normalized space →
    NHWC (B, H/32, W/32, 2048) in `compute_dtype` (None: the weights'
    dtype). `stage_sizes` counts the blocks of each stage ((3, 4, 23, 3)
    is ResNet-101)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3),
                 compute_dtype: Optional[torch.dtype] = None):
        # the ReLU module holds the reference's child index 2; forward
        # applies F.relu
        layers = [nn.Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64),
                  nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1)]
        in_ch, planes = 64, 64
        for stage, blocks in enumerate(stage_sizes):
            stage_blocks = []
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                stage_blocks.append(Bottleneck(in_ch, planes, stride,
                                               downsample=block == 0))
                in_ch = planes * 4
            layers.append(nn.Sequential(*stage_blocks))
            planes *= 2
        super().__init__(*layers)
        self.stage_sizes = tuple(stage_sizes)
        self.out_channels = in_ch
        self.compute_dtype = compute_dtype
        # weights in channels_last too, so cuDNN converts nothing per call
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv1, bn1, _, pool, *stages = self
        dtype = self.compute_dtype or conv1.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = pool(F.relu(bn1(_conv(conv1, x, dtype), train)))
        for stage in stages:
            for block in stage:
                x = block(x, train, dtype)
        return x.permute(0, 2, 3, 1)


def resnet101_features(compute_dtype: Optional[torch.dtype] = None
                       ) -> ResNetFeatures:
    return ResNetFeatures(stage_sizes=(3, 4, 23, 3),
                          compute_dtype=compute_dtype)


def resnet50_features(compute_dtype: Optional[torch.dtype] = None
                      ) -> ResNetFeatures:
    return ResNetFeatures(stage_sizes=(3, 4, 6, 3),
                          compute_dtype=compute_dtype)
