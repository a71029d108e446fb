"""Ground-truth-box dense captioner — port of `GTDenseCaptioner` in
`imagecaptioning_tpu/models/densecap.py:59-206`, LSTM head only.

AlexGTModel path: VGG16 trunk → bilinear ROI pooling of ground-truth
boxes (the hand-written CUDA kernel on the card) → VGG classifier head
(4096-d region codes) → LSTM caption head per region. Images are
batched with padded region slabs (R regions per image) and the regions
are flattened into the caption head's batch axis.

Module names follow the reference AlexGTModel state-dict layout
(`features.{idx}`, `classifier.0/.3`, `llm.*`), so a reference `.pth`
and `utils.weights.gt_state_dict_from_jax`'s output both load with
`load_state_dict`. The trunk and classifier hold their weights in
`compute_dtype` (bf16 in serving, as `DenseConfig.compute_dtype` says);
ROI pooling sums in fp32 and writes fc6's input in `compute_dtype` (the
kernel's fused CHW epilogue); the LSTM head runs in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.vgg import (VGGClassifierHead,
                                                            VGGFeatures)
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops import tokens
from imagecaptioning_tpu_torch.ops.roi_align import roi_align_batch_chw


class GTDenseOutput(NamedTuple):
    logits: torch.Tensor        # (N, R, T+1, V+3)
    region_codes: torch.Tensor  # (N, R, 4096)


class GTDenseCaptioner(nn.Module):
    """Ground-truth-box dense captioner (the AlexGTModel path)."""

    def __init__(self, vocab_size: int, seq_length: int,
                 use_lstm: bool = True, embedding_size: int = 512,
                 rnn_size: int = 512, num_lstm_layers: int = 1,
                 dropout: float = 0.0, roi_size: Tuple[int, int] = (7, 7),
                 vgg_stages: int = 5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not use_lstm:
            raise NotImplementedError(
                "the GT transformer head is not ported yet (ROADMAP.md, "
                "Queue 1, Slice C — the GT transformer head)")
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.roi_size = tuple(roi_size)
        self.features = VGGFeatures(include_final_pool=True,
                                    end_stage=vgg_stages)
        c = self.features.out_channels
        self.classifier = VGGClassifierHead(c * roi_size[0] * roi_size[1])
        self.features.to(compute_dtype)
        self.classifier.to(compute_dtype)
        self.llm = LanguageHead(vocab_size, embedding_size, rnn_size,
                                num_lstm_layers, dropout)

    @property
    def spec(self) -> tokens.TokenSpec:
        return tokens.TokenSpec.alexcap(self.vocab_size)

    def encode_regions(self, images: torch.Tensor,
                       gt_boxes: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) normalized, gt_boxes (N, R, 4) xcycwh in
        image coords → region codes (N, R, 4096) fp32."""
        feats = self.features(images)     # (N, Hf, Wf, C) view, compute dtype
        ih, iw = images.shape[1], images.shape[2]
        # one pass from the trunk's output to fc6's input: pooled codes
        # flattened in the reference's CHW row order, in fc6's dtype
        flat = roi_align_batch_chw(feats, gt_boxes.float().contiguous(),
                                   (float(ih), float(iw)), self.roi_size,
                                   out_dtype=self.classifier[0].weight.dtype)
        return self.classifier(flat).float()

    def forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor) -> GTDenseOutput:
        """Teacher-forced logits for gt_labels (N, R, T)."""
        n, r, t = gt_labels.shape
        codes = self.encode_regions(images, gt_boxes)
        dec_in = tokens.decoder_input(gt_labels.reshape(n * r, t),
                                      self.spec.start)
        logits = self.llm(codes.reshape(n * r, 1, -1), dec_in)
        return GTDenseOutput(logits.reshape(n, r, t + 1, -1), codes)

    # --- decode API (drives models.decoding greedy/beam) ---------------
    def encode_flat(self, images: torch.Tensor,
                    gt_boxes: torch.Tensor) -> torch.Tensor:
        """Decode-ready per-region conditioning, (N*R, 1, 4096)."""
        codes = self.encode_regions(images, gt_boxes)
        n, r, d = codes.shape
        return codes.reshape(n * r, 1, d)

    def init_decode(self, flat_enc: torch.Tensor):
        return self.llm.init_state(flat_enc)

    def decode_step(self, carry, toks: torch.Tensor, t: int):
        """(carry, tokens (B, 1), step) → (carry, logits (B, V+3))."""
        logits, carry = self.llm.step(toks, carry)
        return carry, logits
