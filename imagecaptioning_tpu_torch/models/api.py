"""Region decode API — port of the region half of
`imagecaptioning_tpu/models/api.py` (`_make_region_step` and
`_beam_invariant_step`, `make_region_greedy_fn`, `make_region_beam_fn`,
:48-88, :225-298), for the LSTM and the transformer head.

Each `make_*` returns a closure `(images, boxes) -> result` over a
`GTDenseCaptioner` that holds its own weights; it runs under
`torch.inference_mode` on whatever device the model and inputs are on.
The per-region carry and step (the beam-invariant split of
`_make_region_step`) come from the model's `init_decode`.
"""

from __future__ import annotations

from typing import Callable

import torch

from imagecaptioning_tpu_torch.models import decoding


def make_region_greedy_fn(model, max_steps: int) -> Callable:
    """(images, boxes) → tokens (N*R, max_steps): greedy decode over every
    (padded) region of the batch."""

    @torch.inference_mode()
    def run(images, boxes):
        flat_enc = model.encode_flat(images, boxes)
        carry, step = model.init_decode(flat_enc)
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
        carry, step = model.init_decode(flat_enc, beam_size)
        return decoding.beam_search(
            step, carry, flat_enc.shape[0], beam_size,
            start_token=model.spec.start, end_token=model.spec.end,
            max_steps=max_steps, use_logprobs=use_logprobs)
    return run
