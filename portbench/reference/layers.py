"""Plain PyTorch layers of the DenseCap models, in float32.

Written from the published description (Johnson, Karpathy and Fei-Fei,
"DenseCap", CVPR 2016; jcjohnson/densecap) and imports nothing of the
measured program. Every function takes its weights as a dict keyed by the
names the parameters carry in the torchvision-style state-dict layout
(`conv_trunk.0.weight`, `recog_base.0.weight`, `llm.lstm.weight_ih_l0`,
...), so that the benchmark can hand the same seeded tensors to the
program and to this reference.

`Precision` says how the layers that the configuration computes in a
narrow type (the VGG trunk, the RPN's 3x3 conv and fc6/fc7) are
computed here: exactly in float32 (the reference), or with their inputs,
weights and the outputs the program keeps in the narrow type (the trunk's
map, the RPN conv's, the region codes) rounded to fp8 e4m3, and the
gradients of each to e5m2, under per-tensor scales (the control: the step
below bfloat16 that a later change might be tempted to take, forward and
backward).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# VGG16's convolutions, (out channels) per stage, 2x2/2 max-pool after a stage
VGG16 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
         (512, 512, 512))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Precision:
    """fp8=True computes the narrow layers' products in fp8 (the
    control)."""
    fp8: bool = False


EXACT = Precision()
FP8 = Precision(fp8=True)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to an fp8 type under a per-tensor scale that maps its
    largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: its gradient in e5m2 (the
    two fp8 types of fp8 training)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t in fp8 on the way forward, and its gradient on the way back."""
    return _Fp8.apply(t)


def narrow(t: torch.Tensor, prec: Precision) -> torch.Tensor:
    return fp8_round(t) if prec.fp8 else t


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> ImageNet-normalised float32 (N, 3, H, W)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def vgg_conv_names(stages: int) -> List[str]:
    """The trunk's conv layers as torchvision indexes them (a conv, its
    ReLU, and a pool after each stage below the fifth)."""
    names, idx = [], 0
    for s in range(stages):
        for _ in VGG16[s]:
            names.append(str(idx))
            idx += 2
        if s < len(VGG16) - 1:
            idx += 1
    return names


def vgg16_trunk(x: torch.Tensor, w: Weights, prefix: str, stages: int,
                final_pool: bool, prec: Precision = EXACT) -> torch.Tensor:
    """NCHW float32 -> the trunk's NCHW map: 3x3 convs (padding 1) and
    ReLUs, a 2x2/2 max-pool after every stage below the fifth, and after
    the fifth too with `final_pool`."""
    names = iter(vgg_conv_names(stages))
    for s in range(stages):
        for _ in VGG16[s]:
            n = next(names)
            x = F.relu(F.conv2d(narrow(x, prec),
                                narrow(w[f"{prefix}.{n}.weight"], prec),
                                w[f"{prefix}.{n}.bias"], padding=1))
        if s < len(VGG16) - 1 or final_pool:
            x = F.max_pool2d(x, 2, 2)
    return narrow(x, prec)


def roi_pool(features: torch.Tensor, boxes: torch.Tensor,
             image_hw: Tuple[float, float], out_hw=(7, 7)) -> torch.Tensor:
    """DenseCap's bilinear ROI pooling (BoxToAffine -> affine_grid ->
    grid_sample, align_corners=False, zeros outside): features
    (N, C, Hf, Wf), boxes (N, R, 4) xcycwh in 1-indexed image pixels ->
    (N, R, C*oh*ow), each region's cells flattened channel-major (the
    layout fc6 reads). Differentiable in the features and the boxes."""
    n, c = features.shape[:2]
    r = boxes.shape[1]
    oh, ow = out_hw
    ih, iw = image_hw
    xc, yc, bw, bh = boxes.reshape(-1, 4).unbind(-1)
    zero = torch.zeros_like(xc)
    theta = torch.stack([
        torch.stack([bw / iw, zero, (2 * xc - 1 - iw) / (iw - 1)], -1),
        torch.stack([zero, bh / ih, (2 * yc - 1 - ih) / (ih - 1)], -1),
    ], 1)
    grid = F.affine_grid(theta, [n * r, 1, oh, ow], align_corners=False)
    out = F.grid_sample(features, grid.reshape(n, r * oh, ow, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)              # (N, C, R*oh, ow)
    out = out.reshape(n, c, r, oh, ow).permute(0, 2, 1, 3, 4)
    return out.reshape(n, r, c * oh * ow)


def classifier(x: torch.Tensor, w: Weights, prefix: str,
               dropout_mask: Optional[torch.Tensor] = None,
               keep: float = 0.5, prec: Precision = EXACT) -> torch.Tensor:
    """fc6 -> ReLU -> dropout (the given 0/1 mask, scaled by 1/keep) ->
    fc7 -> ReLU (torchvision's vgg16.classifier[:-1])."""
    x = F.relu(F.linear(narrow(x, prec), narrow(w[f"{prefix}.0.weight"],
                                                prec),
                        w[f"{prefix}.0.bias"]))
    if dropout_mask is not None:
        x = x * dropout_mask / keep
    return narrow(F.relu(F.linear(narrow(x, prec),
                                  narrow(w[f"{prefix}.3.weight"], prec),
                                  w[f"{prefix}.3.bias"])), prec)


def lstm_step(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: Weights, prefix: str):
    """One LSTM cell step, gates (i, f, g, o), separate input and hidden
    biases (torch's nn.LSTM layout)."""
    gates = (x @ w[f"{prefix}.weight_ih_l0"].T + w[f"{prefix}.bias_ih_l0"]
             + h @ w[f"{prefix}.weight_hh_l0"].T + w[f"{prefix}.bias_hh_l0"])
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def caption_logits(codes: torch.Tensor, tokens: torch.Tensor,
                   w: Weights) -> torch.Tensor:
    """DenseCap's language model, teacher-forced: the region code (B,
    4096) encoded, fed once through the LSTM from a zero state as a
    prefix, then the tokens (B, L) one a step -> logits (B, L, V+3)."""
    enc = F.relu(codes @ w["llm.image_encoder.encode.weight"].T
                 + w["llm.image_encoder.encode.bias"])
    hidden = w["llm.lstm.weight_hh_l0"].shape[1]
    h = enc.new_zeros(enc.shape[0], hidden)
    h, c = lstm_step(enc, h, torch.zeros_like(h), w, "llm.lstm")
    emb = w["llm.lookup_table.weight"][tokens]              # (B, L, E)
    outs = []
    for t in range(tokens.shape[1]):
        h, c = lstm_step(emb[:, t], h, c, w, "llm.lstm")
        outs.append(h)
    hs = torch.stack(outs, 1)
    return hs @ w["llm.rnn.linear.weight"].T + w["llm.rnn.linear.bias"]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's 2-norm, in float64 on the host."""
    names = list(tensors)
    got = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                       for k in names]).cpu().tolist()
    return dict(zip(names, got))


class Adam:
    """Adam with additive L2 weight decay (torch.optim.Adam's, not
    AdamW's), bias-corrected, over named float32 tensors; a group's lr
    may be 0 until `start_step` applied updates have been taken."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Dict[str, float],
                 start: Dict[str, int], betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        self.params, self.lr, self.start = params, lr, start
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns each leaf's gradient as the moments took it
        (the decay added)."""
        done, self.t = self.t, self.t + 1
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            lr = self.lr[k] if done >= self.start[k] else 0.0
            if lr == 0.0:
                continue
            bc1 = 1 - self.b1 ** self.t
            bc2 = 1 - self.b2 ** self.t
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
        return taken


@contextmanager
def exact_float32():
    """float32 products and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
