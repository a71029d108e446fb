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
- the carry is a tree (a tensor, or tuples and lists of trees) of
  batch-major (B·K, ...) tensors, gathered along the beam axis with the
  parent indices each step. What is the same for every beam of a batch element
  (the transformer's encoder output and cross-attention keys and values)
  stays out of it: the step closes over it, as JAX's
  `_beam_invariant_step` does.

A decode step is `step_fn(carry, tokens (B, 1), t) -> (carry, logits
(B, V))`, or `(carry, logits, alphas (B, P))` where the caller collects
alphas (`collect_alphas`): greedy then returns them as (B, L, P), and the
beam search as `BeamResult.alphas` (B, K, L, P), each beam's gathered
from its parent every step and reordered with the final order. With
`length_normalize`, a beam's final score is divided by its length (the
first END's index; max_steps where END never comes or comes first).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from imagecaptioning_tpu_torch.utils.profiling import count, span

DecodeStep = Callable[[Any, torch.Tensor, int], Tuple]
NEG = -1e30


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """`fn` over every tensor of a tree of tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(_tree_map(fn, leaf) for leaf in tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


def _gather_beams(carry: Any, parents: torch.Tensor, batch: int,
                  k: int) -> Any:
    """Reindex every (B*K, ...) tensor by per-batch parent beam indices."""
    flat = (parents + k * torch.arange(batch, device=parents.device)[:, None]
            ).reshape(-1)
    return _tree_map(lambda leaf: leaf.index_select(0, flat), carry)


def expand_for_beams(carry: Any, beam_size: int) -> Any:
    """Tile every (B, ...) tensor to (B*K, ...) beam-major within batch."""
    return _tree_map(lambda leaf: leaf.repeat_interleave(beam_size, dim=0),
                    carry)


def greedy_decode(step_fn: DecodeStep, carry: Any, batch: int,
                  start_token: int, max_steps: int,
                  collect_alphas: bool = False,
                  first_logits: Optional[torch.Tensor] = None):
    """Greedy argmax decode for a fixed step count → tokens (B, max_steps),
    or (tokens, alphas (B, max_steps, P)) with `collect_alphas`. `argmax`
    takes the first maximum, as `jnp.argmax` does. Given a prefill's
    `first_logits` (B, V), the first token is their argmax and the steps
    t = 1 .. max_steps - 1 feed each token on; `start_token` is then not
    used (and alphas are not collected). Counts its calls and the steps it
    runs (`decode.calls`, `decode.steps`)."""
    first = 0 if first_logits is None else 1
    count("decode.calls")
    count("decode.steps", max_steps - first)
    with span("decode.greedy"):
        out, alphas = [], []
        if first:
            tok = first_logits.argmax(dim=-1, keepdim=True)
            out.append(tok)
        else:
            tok = torch.full((batch, 1), start_token, dtype=torch.long,
                             device=_first_leaf(carry).device)
        for t in range(first, max_steps):
            carry, logits, *step_alphas = step_fn(carry, tok, t)
            tok = logits.argmax(dim=-1, keepdim=True)
            out.append(tok)
            if collect_alphas:
                alphas.append(step_alphas[0].float())
        tokens = torch.cat(out, dim=1)
        return ((tokens, torch.stack(alphas, dim=1)) if collect_alphas
                else tokens)


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # (B, K, L) best-first
    scores: torch.Tensor      # (B, K)
    finished: torch.Tensor    # (B, K) bool
    alphas: Optional[torch.Tensor] = None     # (B, K, L, P)


def beam_search(step_fn: DecodeStep, carry: Any, batch: int, beam_size: int,
                start_token: int, end_token: int, max_steps: int,
                use_logprobs: bool = False, length_normalize: bool = False,
                collect_alphas: bool = False) -> BeamResult:
    """Fixed-shape batched beam search. `carry` must already be expanded
    to B*K along its batch axis (beam-major within batch)."""
    k = beam_size
    device = _first_leaf(carry).device
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
    alphas = None

    for t in range(max_steps):
        carry, logits, *step_alphas = step_fn(carry, cur, t)
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
        if collect_alphas:
            sa = step_alphas[0].float().reshape(batch, k, -1)
            if alphas is None:
                alphas = sa.new_zeros((batch, k, max_steps, sa.shape[-1]))
            alphas = alphas.gather(1, parents[..., None, None].expand(
                -1, -1, *alphas.shape[2:]))
            alphas[:, :, t] = sa.gather(1, parents[..., None].expand(
                -1, -1, sa.shape[-1]))
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
    if length_normalize:
        lengths = (tokens == end_token).to(torch.int32).argmax(dim=-1)
        lengths = torch.where(lengths == 0, max_steps, lengths)
        final = final / lengths.clamp_min(1).float()
    # Prefer finished beams (an unfinished beam wins only if none finished).
    any_finished = finished.any(dim=1, keepdim=True)
    rank = torch.where(any_finished & ~finished,
                       torch.full_like(final, NEG), final)
    # stable, like jnp.argsort, so equal ranks keep their beam order
    order = torch.argsort(-rank, dim=1, stable=True)
    tokens = tokens.gather(1, order[..., None].expand(-1, -1, max_steps))
    if collect_alphas:
        alphas = alphas.gather(1, order[..., None, None].expand(
            -1, -1, *alphas.shape[2:]))
    return BeamResult(tokens, rank.gather(1, order), finished.gather(1, order),
                      alphas)
