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
`load_state_dict`. The trunk and classifier compute in `compute_dtype`
(bf16, as `DenseConfig.compute_dtype` says) and hold their weights in
`param_dtype`: by default the same (serving), fp32 for training (the
master weights of `DenseConfig.param_dtype`, as flax keeps them). ROI
pooling sums in fp32 and writes fc6's input in `compute_dtype` (the
kernel's fused CHW epilogue), and differentiates back into the trunk
through the backward kernel; the LSTM head runs in fp32.

Training (`forward(..., train=True)`, JAX `densecap.py:127-180,
208-218`): the classifier's dropout (p=0.5) and the LSTM's inter-layer
dropout act, their masks drawn from the `generator` passed in; with a
`teacher_prob` the caption head runs scheduled sampling instead of
teacher forcing; `loss` is the masked caption CE over real regions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.vgg import (VGGClassifierHead,
                                                            VGGFeatures)
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops import losses, tokens
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
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not use_lstm:
            raise NotImplementedError(
                "the GT transformer head is not ported yet (ROADMAP.md, "
                "Queue 1, Slice C — the GT transformer head)")
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.roi_size = tuple(roi_size)
        self.compute_dtype = compute_dtype
        self.features = VGGFeatures(include_final_pool=True,
                                    end_stage=vgg_stages,
                                    compute_dtype=compute_dtype)
        c = self.features.out_channels
        self.classifier = VGGClassifierHead(c * roi_size[0] * roi_size[1],
                                            compute_dtype=compute_dtype)
        self.features.to(param_dtype or compute_dtype)
        self.classifier.to(param_dtype or compute_dtype)
        self.llm = LanguageHead(vocab_size, embedding_size, rnn_size,
                                num_lstm_layers, dropout)

    @property
    def spec(self) -> tokens.TokenSpec:
        return tokens.TokenSpec.alexcap(self.vocab_size)

    def encode_regions(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """images (N, H, W, 3) normalized, gt_boxes (N, R, 4) xcycwh in
        image coords → region codes (N, R, 4096) fp32."""
        feats = self.features(images)     # (N, Hf, Wf, C) view, compute dtype
        ih, iw = images.shape[1], images.shape[2]
        # one pass from the trunk's output to fc6's input: pooled codes
        # flattened in the reference's CHW row order, in fc6's dtype; the
        # boxes are data, so only the features' gradient is taken
        flat = roi_align_batch_chw(feats, gt_boxes.float().contiguous(),
                                   (float(ih), float(iw)), self.roi_size,
                                   out_dtype=self.compute_dtype)
        return self.classifier(flat, train=train, generator=generator).float()

    def forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, train: bool = False,
                teacher_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> GTDenseOutput:
        """Logits for gt_labels (N, R, T): teacher-forced, or with
        scheduled sampling when `train` and `teacher_prob` is given."""
        n, r, t = gt_labels.shape
        codes = self.encode_regions(images, gt_boxes, train, generator)
        flat_codes = codes.reshape(n * r, 1, -1)
        dec_in = tokens.decoder_input(gt_labels.reshape(n * r, t),
                                      self.spec.start)
        if train and teacher_prob is not None:
            logits = self._scheduled_sampling(flat_codes, dec_in,
                                              teacher_prob, generator)
        else:
            logits = self.llm(flat_codes, dec_in, generator=generator,
                              train=train)
        return GTDenseOutput(logits.reshape(n, r, t + 1, -1), codes)

    def _scheduled_sampling(self, flat_codes: torch.Tensor,
                            dec_in: torch.Tensor, teacher_prob: float,
                            generator: Optional[torch.Generator]
                            ) -> torch.Tensor:
        """Curriculum decoding (AlexDenseLangage.py:149-169): at each step
        feed the teacher token with probability `teacher_prob`, else the
        model's own argmax of the previous step; the Bernoulli draws
        (uniform < p, as `jax.random.bernoulli`) come from `generator`."""
        state = self.llm.init_state(flat_codes)
        b, t1 = dec_in.shape
        logits_list = []
        prev_model_tok = dec_in[:, 0]
        for t in range(t1):
            use_teacher = torch.rand(b, generator=generator,
                                     device=dec_in.device) < teacher_prob
            tok = (dec_in[:, t] if t == 0 else
                   torch.where(use_teacher, dec_in[:, t], prev_model_tok))
            logits, state = self.llm.step(tok[:, None], state)
            prev_model_tok = logits.argmax(dim=-1).to(dec_in.dtype)
            logits_list.append(logits)
        return torch.stack(logits_list, dim=1)

    def loss(self, out: GTDenseOutput, gt_labels: torch.Tensor,
             region_mask: torch.Tensor) -> torch.Tensor:
        """Masked caption CE over real regions (AlexGTModel LSTMLoss
        variant: mean over non-NULL targets)."""
        n, r, t1, v = out.logits.shape
        target = tokens.decoder_target(gt_labels.reshape(n * r, -1),
                                       self.spec.end, scan_from=1)
        target = torch.where(region_mask.reshape(n * r, 1) > 0, target, 0)
        return losses.temporal_cross_entropy(
            out.logits.reshape(n * r, t1, v), target)

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
