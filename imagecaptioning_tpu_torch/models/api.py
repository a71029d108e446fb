"""Captioning API — port of `imagecaptioning_tpu/models/api.py`.

AlexCap image captioning (`make_step_fn`, `make_forward_fn`,
`make_greedy_fn`, `make_beam_fn`, :91-222), for the LSTM family: each
`make_*` closes over an `LSTMCaptioner` that holds its own weights. The
LSTM carry (h, c) is kept batch-major (`_lstm_carry_to_batch_major`), so
the beam search gathers it as it gathers the GT carry. Beams score raw
logits by default (`use_logprobs=False`, the JAX default). The decoders
return tokens, or a `BeamResult`: an LSTM's alphas are all zeros, and the
attention families that need them come with Slice E.

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

from typing import Callable, Optional, Tuple

import torch

from imagecaptioning_tpu_torch.models import decoding


def make_step_fn(model) -> Tuple[Callable, Callable]:
    """(init_carry(feats) → carry, step(carry, tokens (B, 1), t) → (carry,
    logits (B, V+3))) for an `LSTMCaptioner`, with the carry (h, c) each
    batch-major (B, L, H)."""
    def init_carry(feats):
        h, c = model.init_decode(feats)
        return (h.transpose(0, 1), c.transpose(0, 1))

    def step(carry, toks, t):
        h, c = carry
        (h, c), logits = model.decode_step(
            (h.transpose(0, 1), c.transpose(0, 1)), toks, t)
        return (h.transpose(0, 1), c.transpose(0, 1)), logits
    return init_carry, step


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


def make_greedy_fn(model, max_steps: int) -> Callable:
    """(preprocessed images) → tokens (B, max_steps)."""
    init_carry, step = make_step_fn(model)

    @torch.inference_mode()
    def run(images):
        carry = init_carry(model.encode(images))
        return decoding.greedy_decode(step, carry, images.shape[0],
                                      model.spec.start, max_steps)
    return run


def make_beam_fn(model, max_steps: int, beam_size: int,
                 use_logprobs: bool = False) -> Callable:
    """(preprocessed images) → BeamResult (tokens (B, K, max_steps)
    best-first). The image prefix runs once per image and its state is
    tiled over the beams (the JAX package runs it once per beam on tiled
    features: the same numbers)."""
    init_carry, step = make_step_fn(model)

    @torch.inference_mode()
    def run(images):
        carry = decoding.expand_for_beams(init_carry(model.encode(images)),
                                          beam_size)
        return decoding.beam_search(
            step, carry, images.shape[0], beam_size,
            start_token=model.spec.start, end_token=model.spec.end,
            max_steps=max_steps, use_logprobs=use_logprobs)
    return run


def make_region_greedy_fn(model, max_steps: int) -> Callable:
    """(images, boxes) → tokens (N*R, max_steps): greedy decode over every
    (padded) region of the batch."""

    @torch.inference_mode()
    def run(images, boxes):
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
