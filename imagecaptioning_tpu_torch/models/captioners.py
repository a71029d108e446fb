"""The four AlexCap caption families — port of
`imagecaptioning_tpu/models/captioners.py` (`LSTMCaptioner`,
`AttentionCaptioner`, `TransformerCaptioner`, `ViTCaptioner`, the encoder
selection `_CNNEncoderMixin`, `build_model`; :58-369):

- `LSTMCaptioner` ← `AlexCap/LSTMModel.py` + `LanguageModule.py`: the
  grid vectors fed through the LSTM head as a prefix, then [START; gt]
  teacher-forced;
- `AttentionCaptioner` ← `LSTMwAttentionModel.py`: the Show-Attend-Tell
  head over the grid, its loss the CE plus `att_reg_weight` times the
  doubly-stochastic regularizer (`LSTMwAttentionModel.py:59-71`);
- `TransformerCaptioner` ← `TransformerModel.py` + `TransformerModule.py`:
  fc → ReLU → a 6-layer encoder over the grid's positions → a 6-layer
  decoder with the sqrt(E) embedding scale;
- `ViTCaptioner` ← `VitbModel.py`: a ViT-B/16 encoder (197 tokens, the
  class token included) → a decoder at its width.

The CNN families' encoder is the reference's switch (`LSTMModel.py:18-27`):
a ResNet trunk (fc_dim 2048, a 7×7 grid at 224²) or, with `use_vggface`,
the VGG16 trunk without its last pool (fc_dim 512, 14×14).

BatchNorm runs on batch statistics, and updates its running statistics,
only while the encoder trains: `train` and not `freeze_encoder` (the
finetune phase). With `freeze_encoder` the trunk runs on its running
statistics under `torch.no_grad()`, so no convolution backward exists:
the reference's frozen-CNN phase (`requires_grad_(False)`,
`train_LSTM.py:48`). The reference also leaves BN in training mode while
the CNN is frozen, drifting its running statistics; the JAX package does
not reproduce that (PARITY.md), and neither does the port. The ViT
encoder has no BatchNorm and no dropout: it is the same function in
training, and `freeze_encoder` only stops its gradient.

Each model is `forward(images, gt, train, generator)` → `TrainOutput`
(logits and, per family, alphas: the attention family's (B, T+1, P), the
Transformer's last cross-attention (B, heads, T+1, P), the ViT's averaged
over heads, (B, T+1, P)), `encode(images)` → what the decoder reads, and
`loss(out, gt)`. `models.api.make_step_fn` builds each family's decode
step. Module names are the reference's state-dict layout (`features.*`,
`llm.*`; the ViT's `encoder_vit.*` in torchvision's names and
`decoder.*`), which `utils.weights` maps a reference `.pth` onto.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.resnet import ResNetFeatures
from imagecaptioning_tpu_torch.models.backbones.vgg import VGGFeatures
from imagecaptioning_tpu_torch.models.backbones.vit import (SelfAttention,
                                                            ViTEncoder)
from imagecaptioning_tpu_torch.models.heads import (AttentionHead,
                                                    LanguageHead,
                                                    TransformerHead)
from imagecaptioning_tpu_torch.ops import losses, tokens
from imagecaptioning_tpu_torch.ops.transformer import Decoder

RESNET101 = (3, 4, 23, 3)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TrainOutput(NamedTuple):
    logits: torch.Tensor                 # (B, T+1, V+3)
    alphas: Optional[torch.Tensor]       # per family (module docstring)


def encoder_name(model_type: str) -> str:
    """The family's encoder module (its state-dict prefix): the ViT's
    `encoder_vit`, else the CNN trunk `features`."""
    return "encoder_vit" if model_type == "vitb" else "features"


def encoder_always_frozen(cfg) -> bool:
    """Whether the config freezes the encoder for the whole run: a
    `trained_encoder` ViT's (`requires_grad=False`, VitbModel.py:162-166).
    It is the model's default, the driver's in every phase, and a hard
    zero in the optimizer."""
    return cfg.model_type == "vitb" and bool(cfg.trained_encoder)


def _fp32_up(x: torch.Tensor) -> torch.Tensor:
    """fp32, or fp64 for an fp64 input."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _CNNCaptioner(nn.Module):
    """The ResNet/VGG encoder of the CNN families (`features`) and its
    BatchNorm and frozen-phase rules (module docstring)."""

    def __init__(self, vocab_size: int, use_vggface: bool,
                 backbone_stages: Sequence[int],
                 compute_dtype: torch.dtype, freeze_encoder: bool):
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

    @property
    def encoder(self) -> nn.Module:
        return self.features

    def _trunk(self, images: torch.Tensor, train: bool) -> torch.Tensor:
        if self.use_vggface:
            return self.features(images)
        return self.features(images, train=train)

    def grid(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Normalized NHWC images → grid vectors (B, H·W, fc_dim) in fp32
        (fp64 for an fp64 trunk); detached from the trunk's weights when
        the encoder is frozen."""
        if self.freeze_encoder:
            with torch.no_grad():
                feats = self._trunk(images, False)
        else:
            feats = self._trunk(images, train)
        b, h, w, c = feats.shape
        return _fp32_up(feats).reshape(b, h * w, c)


class LSTMCaptioner(_CNNCaptioner):
    """CNN trunk (`features`) → LSTM head (`llm`) over a V+3 vocabulary.
    The trunk computes in `compute_dtype`; the head, its input and the
    logits are fp32."""

    def __init__(self, vocab_size: int, embedding_size: int = 1024,
                 rnn_size: int = 768, num_layers: int = 1,
                 dropout: float = 0.0, use_vggface: bool = False,
                 backbone_stages: Sequence[int] = RESNET101,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_encoder: bool = False):
        super().__init__(vocab_size, use_vggface, backbone_stages,
                         compute_dtype, freeze_encoder)
        self.llm = LanguageHead(vocab_size, embedding_size, rnn_size,
                                num_layers, dropout, image_dim=self.fc_dim,
                                output_dropout=True)

    def encode(self, images: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.grid(images, train)

    def forward(self, images: torch.Tensor, gt: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> TrainOutput:
        feats = self.encode(images, train=train)
        dec_in = tokens.decoder_input(gt.long(), self.spec.start)
        return TrainOutput(self.llm(feats, dec_in, generator=generator,
                                    train=train), None)

    def loss(self, out: TrainOutput, gt: torch.Tensor) -> torch.Tensor:
        target = tokens.decoder_target(gt.long(), self.spec.end, scan_from=1)
        return losses.smoothed_cross_entropy(out.logits, target)


class AttentionCaptioner(_CNNCaptioner):
    """CNN trunk → Show-Attend-Tell head (`llm`); the head is fp32."""

    def __init__(self, vocab_size: int, embedding_size: int = 1024,
                 rnn_size: int = 768, dropout: float = 0.5,
                 use_vggface: bool = False, att_reg_weight: float = 1.0,
                 backbone_stages: Sequence[int] = RESNET101,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_encoder: bool = False):
        super().__init__(vocab_size, use_vggface, backbone_stages,
                         compute_dtype, freeze_encoder)
        self.att_reg_weight = att_reg_weight
        self.llm = AttentionHead(vocab_size, embedding_size, self.fc_dim,
                                 rnn_size, dropout)

    def encode(self, images: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.grid(images, train)

    def forward(self, images: torch.Tensor, gt: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> TrainOutput:
        feats = self.encode(images, train=train)
        dec_in = tokens.decoder_input(gt.long(), self.spec.start)
        return TrainOutput(*self.llm(feats, dec_in, generator, train))

    def loss(self, out: TrainOutput, gt: torch.Tensor) -> torch.Tensor:
        target = tokens.decoder_target(gt.long(), self.spec.end, scan_from=1)
        ce = losses.smoothed_cross_entropy(out.logits, target)
        reg = losses.doubly_stochastic_regularizer(out.alphas)
        return ce + self.att_reg_weight * reg


class TransformerCaptioner(_CNNCaptioner):
    """CNN trunk → `llm`: fc (fc_dim → E) + ReLU → Encoder over the grid's
    positions → Decoder (sqrt(E) embedding scale) over `max_length + 1`
    positions. `patch_size_override` sets the encoder's position table
    to its square (default: 14 for VGGFace, 7 for ResNet, the 224² grids);
    a smaller grid reads its first rows."""

    def __init__(self, vocab_size: int, max_length: int,
                 embed_size: int = 512, num_layers: int = 6, heads: int = 8,
                 forward_expansion: int = 4, dropout: float = 0.1,
                 use_vggface: bool = False,
                 backbone_stages: Sequence[int] = RESNET101,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_encoder: bool = False, patch_size_override: int = 0):
        super().__init__(vocab_size, use_vggface, backbone_stages,
                         compute_dtype, freeze_encoder)
        patch = patch_size_override or (14 if use_vggface else 7)
        self.llm = TransformerHead(
            vocab_size, max_length, embed_size, num_layers, heads, dropout,
            image_dim=self.fc_dim, patch_length=patch ** 2,
            forward_expansion=forward_expansion, scale_embedding=True)

    @property
    def decoder(self) -> Decoder:
        return self.llm.decoder

    def encode(self, images: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Images → the encoder's output (B, P, E), fp32."""
        return self.llm.encode(self.grid(images, train), train, generator)

    def forward(self, images: torch.Tensor, gt: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> TrainOutput:
        enc = self.encode(images, train, generator)
        dec_in = tokens.decoder_input(gt.long(), self.spec.start)
        return TrainOutput(*self.decoder(dec_in, enc, train, generator,
                                         return_alphas=True))

    def loss(self, out: TrainOutput, gt: torch.Tensor) -> torch.Tensor:
        target = tokens.decoder_target(gt.long(), self.spec.end, scan_from=0)
        return losses.smoothed_cross_entropy(out.logits, target)


class ViTCaptioner(nn.Module):
    """ViT-B/16 encoder (`encoder_vit`, computing in `compute_dtype`) →
    Decoder (sqrt(E) embedding scale) over `max_length + 1` positions,
    fp32."""

    def __init__(self, vocab_size: int, max_length: int,
                 embed_size: int = 768, num_layers: int = 6, heads: int = 8,
                 forward_expansion: int = 4, dropout: float = 0.1,
                 image_size: int = 224, vit_patch: int = 16,
                 vit_layers: int = 12, vit_heads: int = 12,
                 vit_hidden: int = 768, vit_mlp: int = 3072,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_encoder: bool = False):
        super().__init__()
        self.spec = tokens.TokenSpec.alexcap(vocab_size)
        self.freeze_encoder = freeze_encoder
        self.encoder_vit = ViTEncoder(image_size, vit_patch, vit_layers,
                                      vit_heads, vit_hidden, vit_mlp,
                                      compute_dtype)
        self.decoder = Decoder(vocab_size + 3, embed_size, num_layers, heads,
                               forward_expansion, dropout, max_length + 1,
                               scale_embedding=True)

    @property
    def encoder(self) -> nn.Module:
        return self.encoder_vit

    def encode(self, images: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Images → the ViT's 1 + (S/P)² tokens (B, 197, hidden), fp32;
        the same function in training (VitbModel.py:162-166)."""
        if self.freeze_encoder:
            with torch.no_grad():
                return _fp32_up(self.encoder_vit(images))
        return _fp32_up(self.encoder_vit(images))

    def forward(self, images: torch.Tensor, gt: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> TrainOutput:
        enc = self.encode(images)
        dec_in = tokens.decoder_input(gt.long(), self.spec.start)
        logits, alphas = self.decoder(dec_in, enc, train, generator,
                                      return_alphas=True)
        return TrainOutput(logits, alphas.mean(dim=1))

    def loss(self, out: TrainOutput, gt: torch.Tensor) -> torch.Tensor:
        target = tokens.decoder_target(gt.long(), self.spec.end, scan_from=0)
        return losses.smoothed_cross_entropy(out.logits, target)


def _store(module: nn.Module, dtype: torch.dtype) -> None:
    """Convolution and product weights of `module` in `dtype`; norms, the
    class token and position tables keep theirs."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
        elif isinstance(m, SelfAttention):
            m.in_proj_weight.data = m.in_proj_weight.data.to(dtype)
            m.in_proj_bias.data = m.in_proj_bias.data.to(dtype)


def build_model(cfg, vocab_size: int, seq_length: int,
                freeze_encoder: Optional[bool] = None,
                device: Optional[torch.device] = None) -> nn.Module:
    """Config → model (the reference's per-driver constructor switch,
    `train_LSTM.py:41-47`), built on `device`: the encoder computes in
    `cfg.compute_dtype` and stores its convolution and product weights in
    `cfg.param_dtype`; BatchNorm, LayerNorm and the heads stay fp32.
    `cfg.backbone_stages=()` keeps ResNet-101 and `cfg.vit_dims=()` the
    real ViT-B/16 (else (image size, patch, layers, heads, hidden, MLP)).
    The encoder is frozen by default iff `encoder_always_frozen(cfg)`;
    `freeze_encoder` overrides it."""
    dtype = DTYPES[cfg.compute_dtype]
    drop = cfg.drop_value if cfg.use_dropout else 0.0
    fe = (encoder_always_frozen(cfg) if freeze_encoder is None
          else bool(freeze_encoder))
    cnn = dict(use_vggface=cfg.use_vggface,
               backbone_stages=tuple(cfg.backbone_stages) or RESNET101,
               compute_dtype=dtype, freeze_encoder=fe)
    with torch.device(device or "cpu"):
        if cfg.model_type == "lstm":
            model = LSTMCaptioner(
                vocab_size, embedding_size=cfg.embedding_size,
                rnn_size=cfg.lstm_size, num_layers=cfg.num_layers,
                dropout=drop, **cnn)
        elif cfg.model_type == "lstm_attention":
            model = AttentionCaptioner(
                vocab_size, embedding_size=cfg.embedding_size,
                rnn_size=cfg.lstm_size, dropout=drop, **cnn)
        elif cfg.model_type == "transformer":
            model = TransformerCaptioner(
                vocab_size, seq_length, embed_size=cfg.transformer_size,
                num_layers=cfg.num_layers, heads=cfg.num_heads,
                dropout=drop, **cnn)
        elif cfg.model_type == "vitb":
            vit = {}
            if cfg.vit_dims:
                s, p, n, h, hid, mlp = cfg.vit_dims
                vit = dict(image_size=s, vit_patch=p, vit_layers=n,
                           vit_heads=h, vit_hidden=hid, vit_mlp=mlp)
            model = ViTCaptioner(
                vocab_size, seq_length, embed_size=cfg.embedding_size,
                num_layers=cfg.num_layers, heads=cfg.num_heads,
                dropout=drop, compute_dtype=dtype, freeze_encoder=fe, **vit)
        else:
            raise ValueError(f"unknown model_type {cfg.model_type}")
    _store(model.encoder, DTYPES[cfg.param_dtype])
    return model
