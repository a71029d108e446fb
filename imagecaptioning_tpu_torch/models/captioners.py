"""The AlexCap LSTM captioner — port of `LSTMCaptioner`, its encoder
selection (`_CNNEncoderMixin`) and the `lstm` branch of `build_model` in
`imagecaptioning_tpu/models/captioners.py:58-140, 324-369`
(`AlexCap/LSTMModel.py` + `LanguageModule.py`).

The encoder is the reference's switch (`LSTMModel.py:18-27`): a ResNet
trunk (fc_dim 2048, a 7×7 grid at 224²) or, with `use_vggface`, the VGG16
trunk without its last pool (fc_dim 512, 14×14). Its grid vectors are fed
through the LSTM head as a prefix, then [START; gt] is teacher-forced.

BatchNorm runs on batch statistics, and updates its running statistics,
only while the encoder trains: `train` and not `freeze_encoder` (the
finetune phase). With `freeze_encoder` the trunk runs on its running
statistics under `torch.no_grad()`, so no convolution backward exists:
the reference's frozen-CNN phase (`requires_grad_(False)`,
`train_LSTM.py:48`). The reference also leaves BN in training mode while
the CNN is frozen, drifting its running statistics; the JAX package does
not reproduce that (PARITY.md), and neither does the port.

The model exposes the JAX package's contract: `forward(images, gt,
train)` → `TrainOutput`, `encode`, `init_decode`, `decode_step` and
`loss`. The other AlexCap families come with Slice E (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.resnet import ResNetFeatures
from imagecaptioning_tpu_torch.models.backbones.vgg import VGGFeatures
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops import losses, tokens

RESNET101 = (3, 4, 23, 3)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TrainOutput(NamedTuple):
    logits: torch.Tensor                 # (B, T+1, V+3)
    alphas: Optional[torch.Tensor]       # (B, T+1, P) or None


class LSTMCaptioner(nn.Module):
    """CNN trunk (`features`) → LSTM head (`llm`) over a V+3 vocabulary.
    The trunk computes in `compute_dtype`; the head, its input and the
    logits are fp32."""

    def __init__(self, vocab_size: int, embedding_size: int = 1024,
                 rnn_size: int = 768, num_layers: int = 1,
                 dropout: float = 0.0, use_vggface: bool = False,
                 backbone_stages: Sequence[int] = RESNET101,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_encoder: bool = False):
        super().__init__()
        self.spec = tokens.TokenSpec.alexcap(vocab_size)
        self.use_vggface = use_vggface
        self.freeze_encoder = freeze_encoder
        if use_vggface:
            self.features = VGGFeatures(include_final_pool=False,
                                        compute_dtype=compute_dtype)
            self.fc_dim = 512
        else:
            self.features = ResNetFeatures(backbone_stages, compute_dtype)
            self.fc_dim = 2048
        self.llm = LanguageHead(vocab_size, embedding_size, rnn_size,
                                num_layers, dropout, image_dim=self.fc_dim,
                                output_dropout=True)

    def _trunk(self, images: torch.Tensor, train: bool) -> torch.Tensor:
        if self.use_vggface:
            return self.features(images)
        return self.features(images, train=train)

    def encode(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Normalized NHWC images → grid vectors (B, H·W, fc_dim) in fp32
        (fp64 for an fp64 trunk); detached from the trunk's weights when
        the encoder is frozen."""
        if self.freeze_encoder:
            with torch.no_grad():
                feats = self._trunk(images, False)
        else:
            feats = self._trunk(images, train)
        b, h, w, c = feats.shape
        return feats.to(torch.promote_types(feats.dtype, torch.float32)
                        ).reshape(b, h * w, c)

    def forward(self, images: torch.Tensor, gt: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> TrainOutput:
        feats = self.encode(images, train=train)
        dec_in = tokens.decoder_input(gt.long(), self.spec.start)
        return TrainOutput(self.llm(feats, dec_in, generator=generator,
                                    train=train), None)

    def init_decode(self, feats: torch.Tensor):
        """The LSTM state after the image prefix, (h, c) each (L, B, H)."""
        return self.llm.init_state(feats)

    def decode_step(self, carry, toks: torch.Tensor, t: int):
        """→ (carry, logits (B, V+3)). The JAX package also returns an
        LSTM's alphas, all zeros; the attention families that have them
        come with Slice E."""
        logits, carry = self.llm.step(toks, carry)
        return carry, logits

    def loss(self, out: TrainOutput, gt: torch.Tensor) -> torch.Tensor:
        target = tokens.decoder_target(gt.long(), self.spec.end, scan_from=1)
        return losses.smoothed_cross_entropy(out.logits, target)


def build_model(cfg, vocab_size: int, seq_length: int,
                freeze_encoder: Optional[bool] = None,
                device: Optional[torch.device] = None) -> LSTMCaptioner:
    """Config → model (the reference's per-driver constructor switch,
    `train_LSTM.py:41-47`), built on `device`: the trunk computes in
    `cfg.compute_dtype` and stores its convolutions' weights in
    `cfg.param_dtype`; BatchNorm and the head stay fp32.
    `cfg.backbone_stages=()` keeps ResNet-101. The other families raise
    until Slice E (ROADMAP.md, Queue 1)."""
    del seq_length      # the LSTM needs no position table
    if cfg.model_type != "lstm":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet (ROADMAP.md, "
            f"Queue 1, Slice E — the other caption families)")
    with torch.device(device or "cpu"):
        model = LSTMCaptioner(
            vocab_size, embedding_size=cfg.embedding_size,
            rnn_size=cfg.lstm_size, num_layers=cfg.num_layers,
            dropout=cfg.drop_value if cfg.use_dropout else 0.0,
            use_vggface=cfg.use_vggface,
            backbone_stages=tuple(cfg.backbone_stages) or RESNET101,
            compute_dtype=DTYPES[cfg.compute_dtype],
            freeze_encoder=bool(freeze_encoder))
    for m in model.features.modules():
        if isinstance(m, nn.Conv2d):
            for p in m.parameters():
                p.data = p.data.to(DTYPES[cfg.param_dtype])
    return model
