"""Mixture-of-experts routing and the experts' grouped products, for the
region language model (`models/moe_lm.py`, DeepSeek-V3's MoE as
Kimi-VL-A3B configures it). No TPU kernel corresponds: the JAX package has
no expert layer.

- `route`: the `noaux_tc` rule with one group. Sigmoid scores of the fp32
  router logits; each token's `top_k` experts chosen on score plus the
  correction bias; the chosen scores (without the bias) normalised to
  sum 1 and multiplied by the routed scaling factor.
- `dispatch`: the token-by-expert assignments sorted by expert, the
  offsets of each expert's rows, all on the device (no host sync, so a
  step can be captured as a CUDA graph).
- `grouped_mm`: one product per expert over its own rows, (M, K) rows
  sorted by expert against (E, K, N) weights. On a bf16 CUDA tensor one
  `torch._grouped_mm` launch (fp32 accumulation): the decode reads every
  expert's weights once a step, so it is bound by their bytes, and one
  launch reads each expert's tile of weights once for all its rows. In
  any other case (a CPU tensor, or float32 on the card) the plain
  per-expert loop, `grouped_mm_reference`, which the tests hold the
  card's path to; it reads the offsets back to the host.
  `grouped_mm.launches` counts the grouped launches.
- `experts_swiglu`: the routed experts of a layer, gate and up in one
  grouped product, SiLU(gate) * up, down in a second, then the rows put
  back in token order and summed under the routing weights in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def route(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float, normalize: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 router logits (T, E), the correction bias (E,) -> (weights
    (T, top_k) fp32, expert ids (T, top_k))."""
    scores = logits.float().sigmoid()
    idx = (scores + bias.float()).topk(top_k, dim=-1, sorted=False).indices
    w = scores.gather(-1, idx)
    if normalize and top_k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * scale, idx


def dispatch(idx: torch.Tensor, n_experts: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert ids (T, k) -> (order (T*k,): the flat assignments sorted by
    expert, stably; offs (E,) int32: each expert's end row). The offsets
    are searched in the sorted ids (`bincount` would read its input's
    maximum back to the host)."""
    ids, order = idx.reshape(-1).sort(stable=True)
    experts = torch.arange(n_experts, device=idx.device)
    return order, torch.searchsorted(ids, experts, right=True).to(
        torch.int32)


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor,
                         offs: torch.Tensor) -> torch.Tensor:
    """Rows x (M, K) sorted by expert, w (E, K, N), offs (E,) -> (M, N):
    expert e's rows times w[e], one product an expert."""
    out = x.new_zeros(x.shape[0], w.shape[-1])
    ends = offs.tolist()
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            out[start:end] = x[start:end] @ w[e]
        start = end
    return out


def grouped_on_card(x: torch.Tensor) -> bool:
    """Whether `grouped_mm` takes rows like `x` in one grouped launch,
    with no read back to the host (so a CUDA graph can hold it)."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """`grouped_mm_reference`'s product: one grouped launch for bf16 on
    the card, the plain loop otherwise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"grouped_mm runs on cuda or cpu, not {x.device}")
    if not grouped_on_card(x):
        return grouped_mm_reference(x, w, offs)
    grouped_mm.launches += 1
    return torch._grouped_mm(x, w, offs=offs)


grouped_mm.launches = 0


def experts_swiglu(x: torch.Tensor, weights: torch.Tensor,
                   idx: torch.Tensor, gate_up: torch.Tensor,
                   down: torch.Tensor) -> torch.Tensor:
    """Tokens x (T, D), routing weights and ids (T, k), stacked experts
    gate_up (E, D, 2F) and down (E, F, D) -> the weighted sum of each
    token's experts, (T, D) fp32."""
    t, k = idx.shape
    order, offs = dispatch(idx, gate_up.shape[0])
    rows = x.index_select(0, order // k)
    h = grouped_mm(rows, gate_up, offs)
    g, u = h.chunk(2, dim=-1)
    y = grouped_mm(F.silu(g) * u, down, offs)
    back = torch.empty_like(y).index_copy_(0, order, y)
    return (back.view(t, k, -1).float() * weights[..., None]).sum(1)
