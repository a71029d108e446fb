"""Captioning API — port of `imagecaptioning_tpu/models/api.py`.

AlexCap image captioning (`make_step_fn`, `make_forward_fn`,
`make_greedy_fn`, `make_beam_fn`, `CaptioningModel`; :91-222, 300-353),
for the four families of `models.captioners`, each closing over a model
that holds its own weights. What is the same for every beam of an image
stays out of the carry and the step closes over it (JAX's
`_partition_carry`/`_beam_invariant_step`), so that beam search gathers
only what differs per beam:
- LSTM: the carry is (h, c), kept batch-major (B, L, H);
- attention-LSTM: the carry is (h, c), (B, H) each; the grid vectors and
  their attention keys W·feat, tiled to the beams once, are closed over;
- Transformer and ViT: the carry is each decoder layer's self-attention
  cache; the cross-attention keys and values of the (beam-tiled) encoder
  output are projected once a call (`Decoder.init_state`).
Beams score raw logits by default (`use_logprobs=False`, the JAX
default). Asked to (`collect_alphas`), the decoders also return each
step's attention map: the attention head's alpha, the last decoder
layer's cross-attention averaged over heads, and zeros (B, 1) for the
LSTM, as the JAX package does.

Region decode (the region half: `_make_region_step` and
`_beam_invariant_step`, `make_region_greedy_fn`, `make_region_beam_fn`,
:48-88, :225-298), for the GT captioner's LSTM and transformer heads: each
returns a closure `(images, boxes) -> result` over a `GTDenseCaptioner`;
the per-region carry and step (the beam-invariant split of
`_make_region_step`) come from the model's `init_decode`.

The decoders run under `torch.inference_mode` on whatever device the
model and inputs are on.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.models import decoding
from imagecaptioning_tpu_torch.models.captioners import (AttentionCaptioner,
                                                         TransformerCaptioner,
                                                         ViTCaptioner)
from imagecaptioning_tpu_torch.utils.profiling import span


def make_step_fn(model, max_steps: int, beam_size: int = 1,
                 collect_alphas: bool = False) -> Callable:
    """`start(feats) → (carry, step)` for an AlexCap captioner: `feats` is
    `model.encode(images)` for B images; the carry is tiled to
    `beam_size` beams per image (beam-major within an image), and
    `step(carry, tokens (B·K, 1), t)` returns (carry, logits (B·K, V+3)),
    with the step's alphas (B·K, P) last when `collect_alphas`."""
    tile = ((lambda x: decoding.expand_for_beams(x, beam_size))
            if beam_size > 1 else (lambda x: x))

    if isinstance(model, (TransformerCaptioner, ViTCaptioner)):
        def start(enc):
            cache, decoder_step = model.decoder.init_state(
                tile(enc), max_steps, alphas=collect_alphas)

            def step(cache, toks, t):
                out = decoder_step(cache, toks, t)
                return (cache, *out) if collect_alphas else (cache, out)
            return cache, step
        return start

    if isinstance(model, AttentionCaptioner):
        def start(feats):
            state = model.llm.init_state(feats)
            feats_k, w_s = tile(feats), tile(model.llm.attention_keys(feats))

            def step(state, toks, t):
                logits, alpha, state = model.llm.step(feats_k, toks, state,
                                                      w_s)
                return ((state, logits, alpha) if collect_alphas
                        else (state, logits))
            return tile(state), step
        return start

    def start(feats):                               # LSTM: batch-major (h, c)
        h, c = model.llm.init_state(feats)

        def step(carry, toks, t):
            h, c = carry
            logits, (h, c) = model.llm.step(
                toks, (h.transpose(0, 1), c.transpose(0, 1)))
            carry = (h.transpose(0, 1), c.transpose(0, 1))
            if collect_alphas:
                return carry, logits, logits.new_zeros((logits.shape[0], 1))
            return carry, logits
        return tile((h.transpose(0, 1), c.transpose(0, 1))), step
    return start


def make_forward_fn(model) -> Callable:
    """(images, gt, generator, train) → (loss, TrainOutput) over
    preprocessed images. In training mode BatchNorm updates its running
    statistics as it normalises (the JAX `apply_train`, whose stats the
    loss function discards, is the same forward)."""
    def forward(images, gt, generator: Optional[torch.Generator] = None,
                train: bool = False):
        out = model(images, gt, train=train, generator=generator)
        return model.loss(out, gt), out
    return forward


def make_greedy_fn(model, max_steps: int,
                   collect_alphas: bool = False) -> Callable:
    """(preprocessed images) → tokens (B, max_steps), or (tokens, alphas
    (B, max_steps, P)) with `collect_alphas`."""
    start_decode = make_step_fn(model, max_steps,
                                collect_alphas=collect_alphas)

    @torch.inference_mode()
    def run(images):
        carry, step = start_decode(model.encode(images))
        return decoding.greedy_decode(step, carry, images.shape[0],
                                      model.spec.start, max_steps,
                                      collect_alphas=collect_alphas)
    return run


def make_beam_fn(model, max_steps: int, beam_size: int,
                 use_logprobs: bool = False, length_normalize: bool = False,
                 collect_alphas: bool = False) -> Callable:
    """(preprocessed images) → BeamResult (tokens (B, K, max_steps)
    best-first; alphas (B, K, max_steps, P) with `collect_alphas`). The
    encoder and the LSTM's image prefix run once per image, tiled over the
    beams (the JAX package runs the prefix once per beam on tiled
    features: the same numbers)."""
    start_decode = make_step_fn(model, max_steps, beam_size, collect_alphas)

    @torch.inference_mode()
    def run(images):
        carry, step = start_decode(model.encode(images))
        return decoding.beam_search(
            step, carry, images.shape[0], beam_size,
            start_token=model.spec.start, end_token=model.spec.end,
            max_steps=max_steps, use_logprobs=use_logprobs,
            length_normalize=length_normalize,
            collect_alphas=collect_alphas)
    return run


def make_region_greedy_fn(model, max_steps: int) -> Callable:
    """(images, boxes) → tokens (N*R, max_steps): greedy decode over every
    (padded) region of the batch."""

    @torch.inference_mode()
    def run(images, boxes):
        with span("gt.greedy"):
            flat_enc = model.encode_flat(images, boxes)
            carry, step = model.init_decode(flat_enc, max_steps=max_steps)
            return decoding.greedy_decode(step, carry, flat_enc.shape[0],
                                          model.spec.start, max_steps)
    return run


def make_region_beam_fn(model, max_steps: int, beam_size: int,
                        use_logprobs: bool = True) -> Callable:
    """(images, boxes) → BeamResult over N*R regions. Log-prob scoring by
    default: both GT beams score with log-softmax
    (`AlexDenseLangage.py:178,195`, `AlexTransformer.py:311`)."""

    @torch.inference_mode()
    def run(images, boxes):
        flat_enc = model.encode_flat(images, boxes)
        carry, step = model.init_decode(flat_enc, beam_size, max_steps)
        return decoding.beam_search(
            step, carry, flat_enc.shape[0], beam_size,
            start_token=model.spec.start, end_token=model.spec.end,
            max_steps=max_steps, use_logprobs=use_logprobs)
    return run


class CaptioningModel:
    """The reference's model contract (`AlexCap/LSTMModel.py:47-86`) over
    an AlexCap captioner: `forward_train(data) → loss` (eval mode),
    `forward_test(data) → (captions, alphas)` greedy, or the best beam's
    with `use_beam`/`beam_size`, `set_eval`, and `llm.decode_sequence`.
    `data` is preprocessed images, or the reference's dict with `image`
    (and `gt_labels`)."""

    def __init__(self, model, vocab, seq_length: int):
        self.model = model
        self.vocab = vocab
        self.seq_length = seq_length
        self.use_beam = False
        self.beam_size = 3
        self.eval_mode = False
        self._fwd = make_forward_fn(model)
        self._greedy = make_greedy_fn(model, seq_length + 1,
                                      collect_alphas=True)
        self._beams = {}
        # the reference exposes the decode as model.llm.decode_sequence
        self.llm = type("LLMShim", (), {})()
        self.llm.decode_sequence = self.decode_sequence

    def set_eval(self, value: bool):
        self.eval_mode = value

    def decode_sequence(self, seq):
        return self.vocab.decode_sequence(np.asarray(
            seq.cpu() if isinstance(seq, torch.Tensor) else seq))

    @staticmethod
    def _unpack(data, gt):
        if gt is None and hasattr(data, "get"):
            return data["image"], data["gt_labels"]
        return data, gt

    def forward_train(self, data, gt=None) -> torch.Tensor:
        images, gt = self._unpack(data, gt)
        self.model.eval()
        with torch.no_grad():
            return self._fwd(images, gt, train=False)[0]

    def forward_test(self, data):
        images = data["image"] if hasattr(data, "get") else data
        self.model.eval()
        if self.use_beam:
            if self.beam_size not in self._beams:
                self._beams[self.beam_size] = make_beam_fn(
                    self.model, self.seq_length + 1, self.beam_size,
                    collect_alphas=True)
            res = self._beams[self.beam_size](images)
            return self.decode_sequence(res.tokens[:, 0]), res.alphas[:, 0]
        toks, alphas = self._greedy(images)
        return self.decode_sequence(toks), alphas
