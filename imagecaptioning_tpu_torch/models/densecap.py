"""Ground-truth-box dense captioner — port of `GTDenseCaptioner` in
`imagecaptioning_tpu/models/densecap.py:59-218`, both caption heads.

AlexGTModel path: VGG16 trunk → bilinear ROI pooling of ground-truth
boxes (the hand-written CUDA kernel on the card) → VGG classifier head
(4096-d region codes) → a caption head per region: the LSTM head
(`use_lstm=True`) or the transformer head (`use_lstm=False`, the
reference's default: fc 4096→E + ReLU → a one-position Encoder → a
Decoder over the V+3 table, E=256, 3 + 3 layers, 4 heads, FFN 4E, no
sqrt(E) embedding scale). Images are batched with padded region slabs
(R regions per image) and the regions are flattened into the caption
head's batch axis.

Module names follow the reference AlexGTModel state-dict layout
(`features.{idx}`, `classifier.0/.3`, `llm.*`: the LSTM head's
`llm.image_encoder`/`lookup_table`/`lstm`/`rnn`, or the transformer's
`llm.fc.0`, `llm.encoder`, `llm.decoder`), so a reference `.pth` and
`utils.weights.gt_state_dict_from_jax`'s output both load with
`load_state_dict`. The trunk and classifier compute in `compute_dtype`
(bf16, as `DenseConfig.compute_dtype` says) and hold their weights in
`param_dtype`: by default the same (serving), fp32 for training (the
master weights of `DenseConfig.param_dtype`, as flax keeps them). ROI
pooling sums in fp32 and writes fc6's input in `compute_dtype` (the
kernel's fused CHW epilogue), and differentiates back into the trunk
through the backward kernel; either caption head runs in fp32.

Training (`forward(..., train=True)`, JAX `densecap.py:127-180,
208-218`): the classifier's dropout (p=0.5) and the head's dropout
(the LSTM's between layers; the transformer's after its embeddings and
norms) act, their masks drawn from the `generator` passed in; with a
`teacher_prob` the LSTM head runs scheduled sampling instead of teacher
forcing (the transformer head ignores it, as JAX does); `loss` is the
masked caption CE over real regions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.vgg import (VGGClassifierHead,
                                                            VGGFeatures)
from imagecaptioning_tpu_torch.models import decoding
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops import losses, tokens
from imagecaptioning_tpu_torch.ops.roi_align import roi_align_batch_chw
from imagecaptioning_tpu_torch.ops.transformer import Decoder, Encoder


class GTDenseOutput(NamedTuple):
    logits: torch.Tensor        # (N, R, T+1, V+3)
    region_codes: torch.Tensor  # (N, R, 4096)


class TransformerHead(nn.Module):
    """The GT transformer caption head (reference `AlexTransformer`):
    `fc.0` (4096 → E) and a ReLU, an Encoder over the one projected code
    (patch_length 1), and a Decoder over the V+3 table with
    `seq_length + 1` positions."""

    def __init__(self, vocab_size: int, seq_length: int, embed_size: int,
                 num_layers: int, heads: int, dropout: float,
                 image_dim: int = 4096):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(image_dim, embed_size), nn.ReLU())
        self.encoder = Encoder(embed_size, num_layers, heads, 4, dropout,
                               patch_length=1)
        self.decoder = Decoder(vocab_size + 3, embed_size, num_layers, heads,
                               4, dropout, max_length=seq_length + 1)

    def encode(self, codes: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Region codes (B, 1, 4096) → encoder output (B, 1, E)."""
        return self.encoder(self.fc(codes), train, generator)

    def forward(self, codes: torch.Tensor, tokens_with_start: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        """Teacher-forced logits (B, T+1, V+3) under the causal × non-NULL
        key mask."""
        enc = self.encode(codes, train, generator)
        return self.decoder(tokens_with_start, enc, train, generator)


class GTDenseCaptioner(nn.Module):
    """Ground-truth-box dense captioner (the AlexGTModel path). The
    transformer head's widths (`embed_size`, `num_layers`, `heads`) are
    the JAX model's defaults; `DenseConfig` has no fields for them."""

    def __init__(self, vocab_size: int, seq_length: int,
                 use_lstm: bool = True, embedding_size: int = 512,
                 rnn_size: int = 512, num_lstm_layers: int = 1,
                 embed_size: int = 256, num_layers: int = 3, heads: int = 4,
                 dropout: float = 0.0, roi_size: Tuple[int, int] = (7, 7),
                 vgg_stages: int = 5,
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_lstm = use_lstm
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
        if use_lstm:
            self.llm = LanguageHead(vocab_size, embedding_size, rnn_size,
                                    num_lstm_layers, dropout)
        else:
            self.llm = TransformerHead(vocab_size, seq_length, embed_size,
                                       num_layers, heads, dropout)

    @property
    def spec(self) -> tokens.TokenSpec:
        if self.use_lstm:
            return tokens.TokenSpec.alexcap(self.vocab_size)
        return tokens.TokenSpec.densecap(self.vocab_size + 3)

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
        scheduled sampling when `train` and `teacher_prob` is given (the
        LSTM head only)."""
        n, r, t = gt_labels.shape
        codes = self.encode_regions(images, gt_boxes, train, generator)
        flat_codes = codes.reshape(n * r, 1, -1)
        dec_in = tokens.decoder_input(gt_labels.reshape(n * r, t),
                                      self.spec.start)
        if self.use_lstm and train and teacher_prob is not None:
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
        variant: mean over non-NULL targets). The transformer's targets
        scan for the first NULL from t=0, the LSTM's from t=1."""
        n, r, t1, v = out.logits.shape
        target = tokens.decoder_target(gt_labels.reshape(n * r, -1),
                                       self.spec.end,
                                       scan_from=1 if self.use_lstm else 0)
        target = torch.where(region_mask.reshape(n * r, 1) > 0, target, 0)
        return losses.temporal_cross_entropy(
            out.logits.reshape(n * r, t1, v), target)

    # --- decode API (drives models.decoding greedy/beam) ---------------
    def encode_flat(self, images: torch.Tensor,
                    gt_boxes: torch.Tensor) -> torch.Tensor:
        """Decode-ready per-region conditioning: the raw codes (N*R, 1,
        4096) for the LSTM head, the encoder output (N*R, 1, E) for the
        transformer."""
        codes = self.encode_regions(images, gt_boxes)
        n, r, d = codes.shape
        flat = codes.reshape(n * r, 1, d)
        return flat if self.use_lstm else self.llm.encode(flat)

    def init_decode(self, flat_enc: torch.Tensor, beam_size: int = 1
                    ) -> Tuple[Any, Callable]:
        """(carry, step) of the per-region decode of `flat_enc`
        (`encode_flat`'s output) for `models.decoding`, with
        `step(carry, tokens (B, 1), t) -> (carry, logits (B, V+3))` and
        the carry already tiled to `beam_size` beams per region. Only what
        differs per beam is in the carry, so that beam search gathers
        nothing else:
        - LSTM head: (h, c) held batch-major, (B, L, H), so beam gathers
          index dim 0; the warm state is computed once per region and
          repeated per beam (the JAX package computes it per beam; every
          copy is identical);
        - transformer head: each layer's self-attention caches, written in
          place at step t. The cross-attention keys and values of the
          beam-tiled encoder output are computed once and the step closes
          over them (JAX's `_partition_carry`/`_beam_invariant_step`)."""
        if self.use_lstm:
            h, c = self.llm.init_state(flat_enc)
            carry = (h.transpose(0, 1), c.transpose(0, 1))

            def step(carry, toks, t):
                logits, (h, c) = self.llm.step(
                    toks, (carry[0].transpose(0, 1), carry[1].transpose(0, 1)))
                return (h.transpose(0, 1), c.transpose(0, 1)), logits
            if beam_size > 1:
                carry = decoding.expand_for_beams(carry, beam_size)
            return carry, step

        if beam_size > 1:
            flat_enc = decoding.expand_for_beams(flat_enc, beam_size)
        cross, cache = self.llm.decoder.init_state(flat_enc)

        def step(cache, toks, t):
            return cache, self.llm.decoder.step(cross, cache, toks, t)
        return cache, step
