"""Dense captioners — port of `imagecaptioning_tpu/models/densecap.py`:
`GTDenseCaptioner` (:59-218) with both caption heads, and the full RPN
model `DenseCapRPN` (:221-545; see its docstring).

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

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.vgg import (VGGClassifierHead,
                                                            VGGFeatures)
from imagecaptioning_tpu_torch.models import decoding
from imagecaptioning_tpu_torch.models.heads import (LanguageHead,
                                                    TransformerHead)
from imagecaptioning_tpu_torch.ops import boxes as boxlib
from imagecaptioning_tpu_torch.ops import losses, tokens
from imagecaptioning_tpu_torch.ops.box_sampler import (SampleResult,
                                                       sample_boxes)
from imagecaptioning_tpu_torch.ops.nms import nms
from imagecaptioning_tpu_torch.ops.roi_align import roi_align_batch_chw
from imagecaptioning_tpu_torch.parallel import mesh
from imagecaptioning_tpu_torch.utils.profiling import span


class GTDenseOutput(NamedTuple):
    logits: torch.Tensor        # (N, R, T+1, V+3)
    region_codes: torch.Tensor  # (N, R, 4096)


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
        with span("gt.trunk"):
            feats = self.features(images)   # (N, Hf, Wf, C) view
        ih, iw = images.shape[1], images.shape[2]
        # one pass from the trunk's output to fc6's input: pooled codes
        # flattened in the reference's CHW row order, in fc6's dtype; the
        # boxes are data, so only the features' gradient is taken
        with span("gt.roi"):
            flat = roi_align_batch_chw(feats, gt_boxes.float().contiguous(),
                                       (float(ih), float(iw)), self.roi_size,
                                       out_dtype=self.compute_dtype)
        with span("gt.classifier"):
            return self.classifier(flat, train=train,
                                   generator=generator).float()

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
            use_teacher = mesh.current().rand(
                (b,), generator=generator, device=dec_in.device) < teacher_prob
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
        with span("gt.encode"):
            codes = self.encode_regions(images, gt_boxes)
            n, r, d = codes.shape
            flat = codes.reshape(n * r, 1, d)
            return flat if self.use_lstm else self.llm.encode(flat)

    def init_decode(self, flat_enc: torch.Tensor, beam_size: int = 1,
                    max_steps: Optional[int] = None
                    ) -> Tuple[Any, Callable]:
        """(carry, step) of the per-region decode of `flat_enc`
        (`encode_flat`'s output) for `models.decoding`, over `max_steps`
        steps (default: the caption's `seq_length + 1`), with
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
        cache, decoder_step = self.llm.decoder.init_state(flat_enc, max_steps)

        def step(cache, toks, t):
            return cache, decoder_step(cache, toks, t)
        return cache, step


# ----------------------------------------------------------------- RPN

# The reference's anchor ladder (LocalizationLayer.py:24-30): 12
# hand-rounded (w, h) rows, 3 aspect ratios × 4 scales. No (s·√r, s/√r)
# formula gives these rows (45×90 at scale 64 but 181×362 at 256), so the
# default sizes and ratios return the table itself.
REFERENCE_ANCHOR_SIZES = (64.0, 128.0, 256.0, 512.0)
REFERENCE_ANCHOR_RATIOS = (0.5, 1.0, 2.0)
REFERENCE_ANCHORS = (
    (45.0, 90.0), (90.0, 45.0), (64.0, 64.0),
    (90.0, 180.0), (180.0, 90.0), (128.0, 128.0),
    (181.0, 362.0), (362.0, 181.0), (256.0, 256.0),
    (362.0, 724.0), (724.0, 362.0), (512.0, 512.0),
)


def default_anchors(sizes=REFERENCE_ANCHOR_SIZES,
                    ratios=REFERENCE_ANCHOR_RATIOS) -> np.ndarray:
    """(len(sizes)·len(ratios), 2) anchor (w, h) table, fp32: the
    reference's table for its sizes and ratios, else (s·√r, s/√r) for
    each size and ratio."""
    if (tuple(sizes) == REFERENCE_ANCHOR_SIZES
            and tuple(ratios) == REFERENCE_ANCHOR_RATIOS):
        return np.asarray(REFERENCE_ANCHORS, dtype=np.float32)
    return np.asarray([[s * np.sqrt(r), s / np.sqrt(r)]
                       for s in sizes for r in ratios], dtype=np.float32)


class RPNOutput(NamedTuple):
    proposals: torch.Tensor   # (N, A, 4) xcycwh
    scores: torch.Tensor      # (N, A)
    trans: torch.Tensor       # (N, A, 4)
    anchors: torch.Tensor     # (A, 4)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (N, A, ...) at idx (N, K) → (N, K, ...)."""
    return x.gather(1, idx.reshape(*idx.shape, *[1] * (x.dim() - 2))
                    .expand(*idx.shape, *x.shape[2:]))


class DenseCapRPN(nn.Module):
    """The full RPN dense-captioning model (DenseCap: `DenseCapModel.py`,
    `LocalizationLayer.py`), JAX `DenseCapRPN` (densecap.py:269-545).

    VGG16 trunk without its last pool (`conv_trunk`, stride 16) → RPN
    head: `rpn_conv` (3×3, 256, ReLU) in `compute_dtype`, then in fp32 the
    1×1 heads `rpn_scores` (k anchors) and `rpn_trans` (4k deltas, zero
    init), flattened per (row, column, anchor) as JAX's NHWC reshape →
    proposals = anchors moved by the deltas (log-scales clamped at
    ±`box_transform_clamp`).

    Training (`forward`): per image `num_pos` positives and `num_neg`
    negatives from `ops.box_sampler`, ranked by uniform keys the caller
    passes or `generator` draws; the sampled proposals (not detached) go
    through the fused ROI entry into `recog_base` (fc6/fc7, dropout in
    training), so on the card autograd reaches `rpn_trans` through the
    backward kernel B, and the trunk through kernel A; then, in fp32,
    `objectness` (normal(0.01) init) and `box_reg` (zero init) on every
    sampled region's code and the LSTM head `llm` on the positives'. The
    loss dict holds the five weighted terms (mid/end objectness and box
    regression on the RPN's and the refined outputs, captioning), their
    sum `total`, `box_decay` (0.5·w·‖trans‖², summed into `total` only
    under `apply_box_decay`, as the reference leaves it out) and
    `pos_occupancy`, the share of positive slots filled.
    `with_captioning=False` is the reference's detection-only RoiModel.

    Serving (`forward_test`, `generate_captions`): clip, NMS at 0.7 with a
    budget of `test_proposals`, ROI codes, objectness and refined boxes,
    NMS at 0.3 on those, greedy captions.

    Parameters keep JAX's module names. `conv_trunk`, `rpn_conv` and
    `recog_base` hold their weights in `param_dtype` (default: the compute
    dtype), the rest in fp32. `ZERO_INIT` names the parameters that
    `utils.weights.seeded_init_` leaves at zero, as JAX initialises them.
    """

    ZERO_INIT = ("rpn_trans.", "box_reg.")

    def __init__(self, vocab_size: int, seq_length: int, num_pos: int = 128,
                 num_neg: int = 128, test_proposals: int = 100,
                 embedding_size: int = 512, rnn_size: int = 512,
                 roi_size: Tuple[int, int] = (7, 7),
                 mid_obj_weight: float = 0.1, mid_reg_weight: float = 0.05,
                 end_obj_weight: float = 0.1, end_reg_weight: float = 0.1,
                 caption_weight: float = 1.0, box_reg_decay: float = 5e-5,
                 box_transform_clamp: float = 10.0, vgg_stages: int = 5,
                 anchor_sizes: Tuple[float, ...] = REFERENCE_ANCHOR_SIZES,
                 anchor_ratios: Tuple[float, ...] = REFERENCE_ANCHOR_RATIOS,
                 with_captioning: bool = True, apply_box_decay: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.num_pos, self.num_neg = num_pos, num_neg
        self.test_proposals = test_proposals
        self.roi_size = tuple(roi_size)
        self.weights = {"mid_objectness": mid_obj_weight,
                        "mid_box_reg": mid_reg_weight,
                        "end_objectness": end_obj_weight,
                        "end_box_reg": end_reg_weight,
                        "captioning": caption_weight}
        self.box_reg_decay = box_reg_decay
        self.box_transform_clamp = box_transform_clamp
        self.vgg_stages = vgg_stages
        self.with_captioning = with_captioning
        self.apply_box_decay = apply_box_decay
        self.compute_dtype = compute_dtype
        # torch.tensor (not from_numpy) honours a `torch.device` context
        self.register_buffer("anchor_wh", torch.tensor(
            default_anchors(anchor_sizes, anchor_ratios)), persistent=False)
        k = self.anchor_wh.shape[0]
        self.conv_trunk = VGGFeatures(include_final_pool=False,
                                      end_stage=vgg_stages,
                                      compute_dtype=compute_dtype)
        c = self.conv_trunk.out_channels
        self.rpn_conv = nn.Conv2d(c, 256, 3, padding=1).to(
            memory_format=torch.channels_last)
        self.rpn_scores = nn.Conv2d(256, k, 1)
        self.rpn_trans = nn.Conv2d(256, 4 * k, 1)
        self.recog_base = VGGClassifierHead(c * roi_size[0] * roi_size[1],
                                            compute_dtype=compute_dtype)
        self.objectness = nn.Linear(4096, 1)
        self.box_reg = nn.Linear(4096, 4)
        for m in (self.rpn_trans, self.box_reg):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)
        nn.init.normal_(self.objectness.weight, std=0.01)
        nn.init.zeros_(self.objectness.bias)
        for m in (self.conv_trunk, self.rpn_conv, self.recog_base):
            m.to(param_dtype or compute_dtype)
        if with_captioning:
            self.llm = LanguageHead(vocab_size, embedding_size, rnn_size)

    @property
    def spec(self) -> tokens.TokenSpec:
        return tokens.TokenSpec.alexcap(self.vocab_size)

    def rpn_forward(self, feats: torch.Tensor) -> RPNOutput:
        """The trunk's output (N, Hf, Wf, C) → every anchor's proposal,
        score and deltas, flattened in (row, column, anchor) order."""
        with span("rpn.head"):
            dtype = self.compute_dtype
            conv = self.rpn_conv
            x = F.conv2d(feats.permute(0, 3, 1, 2), conv.weight.to(dtype),
                         conv.bias.to(dtype), padding=1)
            # NHWC fp32 (a view of the channels_last output), so the 1×1
            # heads are products whose outputs are laid out as JAX
            # flattens them
            x = F.relu(x).float().permute(0, 2, 3, 1)
            n, hf, wf, _ = x.shape
            scores = F.linear(x, self.rpn_scores.weight.flatten(1),
                              self.rpn_scores.bias).reshape(n, -1)
            trans = F.linear(x, self.rpn_trans.weight.flatten(1),
                             self.rpn_trans.bias).reshape(n, -1, 4)
            # the trunk pools (stages − 1) times: stride 2^(stages − 1)
            x0, y0, sx, sy = boxlib.field_centers(self.vgg_stages - 1)
            anchors = boxlib.make_anchors(self.anchor_wh, x0, y0, sx, sy, hf,
                                          wf)
            anchors = anchors.permute(1, 2, 0, 3).reshape(-1, 4)
            proposals = boxlib.apply_box_transform(
                anchors, trans, max_log_scale=self.box_transform_clamp)
            return RPNOutput(proposals, scores, trans, anchors)

    def proposals_only(self, images: torch.Tensor) -> RPNOutput:
        """The raw proposal field for `images` (before sampling and NMS),
        for `eval_split_rpn`'s anchor-assignment diagnostic."""
        return self.rpn_forward(self.conv_trunk(images))

    def region_codes(self, feats: torch.Tensor, boxes: torch.Tensor,
                     image_hw: Tuple[float, float], train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """ROI pooling of boxes (N, R, 4) on the trunk's output through the
        fused CHW entry, then `recog_base` → codes (N, R, 4096) in the
        compute dtype."""
        flat = roi_align_batch_chw(feats, boxes.contiguous(), image_hw,
                                   self.roi_size, out_dtype=self.compute_dtype)
        return self.recog_base(flat, train=train, generator=generator)

    def draw_keys(self, n: int, num_anchors: int,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sampler's uniform keys (positives', negatives'), each (n, A),
        from `generator` (this rank's rows of the global batch's keys in a
        data-parallel step)."""
        keys = mesh.current().rand((2, n, num_anchors), generator=generator,
                                   device=device, batch_axis=1)
        return keys[0], keys[1]

    def sample_regions(self, rpn: RPNOutput, gt_boxes: torch.Tensor,
                       gt_mask: torch.Tensor,
                       keys: Tuple[torch.Tensor, torch.Tensor],
                       image_hw: Tuple[float, float]) -> SampleResult:
        """Each image's positives and negatives among the in-bounds
        proposals (the argmax proposal of a GT wherever it lies)."""
        proposals = rpn.proposals.detach()
        _, in_bounds = boxlib.clip_boxes(proposals, *image_hw)
        return sample_boxes(keys[0], keys[1], proposals, gt_boxes, gt_mask,
                            self.num_pos, self.num_neg, in_bounds=in_bounds)

    def forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                gt_mask: torch.Tensor, gt_labels: torch.Tensor,
                keys: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """images (N, H, W, 3) normalized, GT boxes (N, M, 4) xcycwh, mask
        (N, M), labels (N, M, T) → the loss dict. `keys`: the sampler's
        (positives', negatives') uniform keys, each (N, A); drawn from
        `generator` when None, which also draws the dropout masks when
        `train`."""
        image_hw = (float(images.shape[1]), float(images.shape[2]))
        with span("rpn.trunk"):
            feats = self.conv_trunk(images)
        rpn = self.rpn_forward(feats)
        with span("rpn.sampler"):
            if keys is None:
                keys = self.draw_keys(images.shape[0], rpn.scores.shape[1],
                                      generator, images.device)
            s = self.sample_regions(rpn, gt_boxes, gt_mask, keys, image_hw)
            # positives, then negatives: the regions of the heads below
            all_boxes = _take(rpn.proposals,
                              torch.cat([s.pos_idx, s.neg_idx], 1))
            pos_boxes = all_boxes[:, :self.num_pos]
            pos_targets = _take(gt_boxes, s.pos_target_idx)
            obj_w = torch.cat([s.pos_mask, s.neg_mask], 1).float()

        def objectness_loss(pos_scores, neg_scores):
            """The masked LogisticCriterion per image (targets 1, then 0)."""
            signed = torch.cat([-pos_scores, neg_scores], 1)
            return ((losses.softplus(signed) * obj_w).sum(1)
                    / obj_w.sum(1).clamp_min(1.0))

        with span("rpn.roi_heads"):
            mid_obj = objectness_loss(rpn.scores.gather(1, s.pos_idx),
                                      rpn.scores.gather(1, s.neg_idx))
            mid_reg = losses.box_regression_loss(
                _take(rpn.trans, s.pos_idx),
                boxlib.invert_box_transform(rpn.anchors[s.pos_idx],
                                            pos_targets),
                valid_mask=s.pos_mask)

            codes = self.region_codes(feats, all_boxes, image_hw, train,
                                      generator)
            end_scores = self.objectness(codes.float())[..., 0]
            end_obj = objectness_loss(end_scores[:, :self.num_pos],
                                      end_scores[:, self.num_pos:])
            pos_codes = codes[:, :self.num_pos].float()
            end_reg = losses.box_regression_loss(
                self.box_reg(pos_codes),
                boxlib.invert_box_transform(pos_boxes, pos_targets),
                valid_mask=s.pos_mask)

            # means over the global batch (this rank's part in a
            # data-parallel step); box_decay is a sum, whose part is the
            # local sum
            dp = mesh.current()
            terms = {"mid_objectness": dp.mean(mid_obj),
                     "mid_box_reg": dp.mean(mid_reg),
                     "end_objectness": dp.mean(end_obj),
                     "end_box_reg": dp.mean(end_reg)}
        if self.with_captioning:
            with span("rpn.caption"):
                terms["captioning"] = self._caption_loss(
                    pos_codes, _take(gt_labels, s.pos_target_idx),
                    s.pos_mask, train, generator)
        out = {k: self.weights[k] * v for k, v in terms.items()}
        out["total"] = sum(out.values())
        out["box_decay"] = (0.5 * self.box_reg_decay
                            * rpn.trans.float().square().sum())
        if self.apply_box_decay:
            out["total"] = out["total"] + out["box_decay"]
        out["pos_occupancy"] = dp.mean(s.pos_mask.float())
        return out

    def _caption_loss(self, pos_codes, pos_labels, pos_mask, train,
                      generator) -> torch.Tensor:
        """DenseCap's summed CE of the LSTM head over every positive slot's
        caption (masked slots caption nothing)."""
        t = pos_labels.shape[-1]
        valid = pos_mask.reshape(-1, 1)
        labels = torch.where(valid, pos_labels.reshape(-1, t), 0)
        logits = self.llm(pos_codes.reshape(-1, 1, pos_codes.shape[-1]),
                          tokens.decoder_input(labels, self.spec.start),
                          generator=generator, train=train)
        target = tokens.decoder_target(labels, self.spec.end, scan_from=1)
        return losses.sum_cross_entropy(logits,
                                        torch.where(valid, target, 0))

    def forward_test(self, images: torch.Tensor, nms_thresh: float = 0.7,
                     final_nms_thresh: float = 0.3):
        """Detection: proposals → clip → NMS (`nms_thresh`, budget
        `test_proposals`) → ROI codes → objectness and refined boxes →
        NMS (`final_nms_thresh`) → (boxes (N, P, 4), scores (N, P), codes
        (N, P, 4096), keep (N, P)), P = `test_proposals`, best first."""
        ih, iw = images.shape[1], images.shape[2]
        feats = self.conv_trunk(images)
        rpn = self.rpn_forward(feats)
        clipped, valid = boxlib.clip_boxes(rpn.proposals, ih, iw)
        idx, keep = nms(clipped, rpn.scores, nms_thresh, self.test_proposals,
                        valid=valid)
        boxes = _take(clipped, idx)
        codes = self.region_codes(feats, boxes, (float(ih), float(iw)))
        scores = self.objectness(codes.float())[..., 0]
        refined = boxlib.apply_box_transform(
            boxes, self.box_reg(codes.float()),
            max_log_scale=self.box_transform_clamp)
        fidx, fkeep = nms(refined, scores, final_nms_thresh,
                          self.test_proposals, valid=keep)
        return (_take(refined, fidx), scores.gather(1, fidx),
                _take(codes, fidx), fkeep & keep.gather(1, fidx))

    def generate_captions(self, codes: torch.Tensor,
                          greedy_steps: int) -> torch.Tensor:
        """Greedy captions of region codes (..., 4096) → tokens
        (regions, greedy_steps)."""
        flat = codes.reshape(-1, 1, codes.shape[-1]).float()

        def step(state, toks, t):
            logits, state = self.llm.step(toks, state)
            return state, logits
        return decoding.greedy_decode(step, self.llm.init_state(flat),
                                      flat.shape[0], self.spec.start,
                                      greedy_steps)
