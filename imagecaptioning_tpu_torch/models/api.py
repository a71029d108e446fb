"""Region decode API — port of the region half of
`imagecaptioning_tpu/models/api.py` (`_make_region_step`,
`make_region_greedy_fn`, `make_region_beam_fn`, :225-298).

Each `make_*` returns a closure `(images, boxes) -> result` over a
`GTDenseCaptioner` that holds its own weights; it runs under
`torch.inference_mode` on whatever device the model and inputs are on.
"""

from __future__ import annotations

from typing import Callable

import torch

from imagecaptioning_tpu_torch.models import decoding


def _make_region_step(model):
    """(init_carry, step) for per-region LSTM decode. The carry (h, c) is
    held batch-major, (B, L, H), so beam gathers index dim 0."""
    def init_carry(flat_enc):
        h, c = model.init_decode(flat_enc)
        return (h.transpose(0, 1), c.transpose(0, 1))

    def step(carry, toks, t):
        state = (carry[0].transpose(0, 1), carry[1].transpose(0, 1))
        (h, c), logits = model.decode_step(state, toks, t)
        return (h.transpose(0, 1), c.transpose(0, 1)), logits
    return init_carry, step


def make_region_greedy_fn(model, max_steps: int) -> Callable:
    """(images, boxes) → tokens (N*R, max_steps): greedy decode over every
    (padded) region of the batch."""

    @torch.inference_mode()
    def run(images, boxes):
        flat_enc = model.encode_flat(images, boxes)
        init_carry, step = _make_region_step(model)
        return decoding.greedy_decode(step, init_carry(flat_enc),
                                      flat_enc.shape[0], model.spec.start,
                                      max_steps)
    return run


def make_region_beam_fn(model, max_steps: int, beam_size: int,
                        use_logprobs: bool = True) -> Callable:
    """(images, boxes) → BeamResult over N*R regions. Log-prob scoring by
    default: both GT beams score with log-softmax
    (`AlexDenseLangage.py:178,195`). The warm state is computed once per
    region and repeated per beam (the JAX package computes it per beam;
    every beam's copy is identical)."""

    @torch.inference_mode()
    def run(images, boxes):
        flat_enc = model.encode_flat(images, boxes)
        init_carry, step = _make_region_step(model)
        carry = decoding.expand_for_beams(init_carry(flat_enc), beam_size)
        return decoding.beam_search(
            step, carry, flat_enc.shape[0], beam_size,
            start_token=model.spec.start, end_token=model.spec.end,
            max_steps=max_steps, use_logprobs=use_logprobs)
    return run
