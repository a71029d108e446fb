"""Fixed-shape greedy and beam decoding — port of
`imagecaptioning_tpu/models/decoding.py:37-181`.

The JAX package runs these as `lax.scan`s; here they are Python loops
over `max_steps` with the same fixed shapes and the same rules:

- beams never shrink: a finished beam is frozen (its only continuation
  is END with zero added score) and selection is a top-k over K·V
  candidates each step;
- scores accumulate raw logits unless `use_logprobs` (the GT region
  beam passes True);
- the answer is the best finished beam, the best unfinished one only if
  none finished;
- the carry is a tuple of batch-major (B·K, ...) tensors, gathered along
  the beam axis with the parent indices each step.

A decode step is `step_fn(carry, tokens (B, 1), t) -> (carry, logits
(B, V))`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

DecodeStep = Callable[[Any, torch.Tensor, int], Tuple[Any, torch.Tensor]]
NEG = -1e30


def _gather_beams(carry: Tuple[torch.Tensor, ...], parents: torch.Tensor,
                  batch: int, k: int) -> Tuple[torch.Tensor, ...]:
    """Reindex every (B*K, ...) tensor by per-batch parent beam indices."""
    flat = (parents + k * torch.arange(batch, device=parents.device)[:, None]
            ).reshape(-1)
    return tuple(leaf.index_select(0, flat) for leaf in carry)


def expand_for_beams(carry: Tuple[torch.Tensor, ...],
                     beam_size: int) -> Tuple[torch.Tensor, ...]:
    """Tile every (B, ...) tensor to (B*K, ...) beam-major within batch."""
    return tuple(leaf.repeat_interleave(beam_size, dim=0) for leaf in carry)


def greedy_decode(step_fn: DecodeStep, carry: Any, batch: int,
                  start_token: int, max_steps: int) -> torch.Tensor:
    """Greedy argmax decode for a fixed step count → tokens (B, max_steps).
    `argmax` takes the first maximum, as `jnp.argmax` does."""
    device = next(iter(carry)).device
    tok = torch.full((batch, 1), start_token, dtype=torch.long, device=device)
    out = []
    for t in range(max_steps):
        carry, logits = step_fn(carry, tok, t)
        tok = logits.argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1)


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # (B, K, L) best-first
    scores: torch.Tensor      # (B, K)
    finished: torch.Tensor    # (B, K) bool


def beam_search(step_fn: DecodeStep, carry: Any, batch: int, beam_size: int,
                start_token: int, end_token: int, max_steps: int,
                use_logprobs: bool = False) -> BeamResult:
    """Fixed-shape batched beam search. `carry` must already be expanded
    to B*K along its batch axis (beam-major within batch)."""
    k = beam_size
    device = next(iter(carry)).device
    tokens = torch.full((batch, k, max_steps), end_token, dtype=torch.long,
                        device=device)
    scores = torch.full((batch, k), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0                                   # only beam 0 live
    finished = torch.zeros((batch, k), dtype=torch.bool, device=device)
    fin_scores = torch.full((batch, k), NEG, dtype=torch.float32,
                            device=device)
    cur = torch.full((batch * k, 1), start_token, dtype=torch.long,
                     device=device)
    frozen_row = None

    for t in range(max_steps):
        carry, logits = step_fn(carry, cur, t)
        v = logits.shape[-1]
        logits = logits.float()
        if use_logprobs:
            logits = torch.log_softmax(logits, dim=-1)
        logits = logits.reshape(batch, k, v)
        if frozen_row is None:
            frozen_row = torch.full((v,), NEG, dtype=torch.float32,
                                    device=device)
            frozen_row[end_token] = 0.0

        # Frozen (finished) beams may only emit END with no score change.
        step_scores = torch.where(finished[..., None], frozen_row, logits)
        cand = (scores[..., None] + step_scores).reshape(batch, k * v)
        top_scores, top_idx = cand.topk(k, dim=1)            # (B, K)
        parents = top_idx // v
        words = top_idx % v

        tokens = tokens.gather(1, parents[..., None].expand(-1, -1, max_steps))
        tokens[:, :, t] = words
        was_finished = finished.gather(1, parents)
        is_end = words == end_token
        newly_done = is_end & ~was_finished
        finished = was_finished | is_end
        fin_scores = torch.where(newly_done, top_scores,
                                 fin_scores.gather(1, parents))
        scores = torch.where(
            finished,
            torch.where(newly_done, top_scores, scores.gather(1, parents)),
            top_scores)

        carry = _gather_beams(carry, parents, batch, k)
        cur = words.reshape(batch * k, 1)

    final = torch.where(finished, fin_scores, scores)
    # Prefer finished beams (an unfinished beam wins only if none finished).
    any_finished = finished.any(dim=1, keepdim=True)
    rank = torch.where(any_finished & ~finished,
                       torch.full_like(final, NEG), final)
    # stable, like jnp.argsort, so equal ranks keep their beam order
    order = torch.argsort(-rank, dim=1, stable=True)
    tokens = tokens.gather(1, order[..., None].expand(-1, -1, max_steps))
    return BeamResult(tokens, rank.gather(1, order), finished.gather(1, order))
