"""The least time the card could take for the routed experts' grouped
products of the region language model: each launch's rows read once, its
output written once and the weights of each expert that has a row read
once, at the H100's published 3.35 TB/s, against its operations at the
bf16 tensor-core peak of 989 TFLOP/s, the larger of the two, summed over
the launches (two a MoE layer a forward: gate and up side by side, then
down).

How many experts a launch reads depends on the routing, and so on the
data: seeded weights route unevenly (most forwards reach 16-42 of the 64
experts). The benchmark therefore records each launch's rows and experts
with rows (`record`, which counts what the program's dispatch produced)
on the traced calls themselves, run again after the trace: a request's
routing depends on its inputs alone. `expected_assignments` gives the
token-expert pairs a call must compute, from the shapes, to hold the
program's own count (`moe.assignments`) and the recorded rows to.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, List, Tuple

from portbench.peaks import PEAKS

HBM_BYTES_PER_S = PEAKS["H100"]["hbm_bytes_per_s"]
BF16_FLOPS = PEAKS["H100"]["bf16_flops"]
ELEM = 2                                   # bf16 weights and activations

# substrings of the grouped-product kernels' device names in a profiler
# trace (`torch._grouped_mm`'s CUTLASS kernels on the H100)
KERNELS = ("GroupProblemShape",)


def launch_ms(rows: int, k: int, n: int, experts: int) -> float:
    """One grouped product: rows (rows, k) against `experts` (k, n)
    weights."""
    nbytes = ELEM * (experts * k * n + rows * k + rows * n)
    flops = 2 * rows * k * n
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def bound_ms(cfg: Dict, layers: Iterable[Tuple[int, int]]) -> float:
    """The summed bound of MoE layer calls, each (rows, experts with
    rows): its gate-and-up product and its down product."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return sum(launch_ms(m, d, 2 * f, e) + launch_ms(m, f, d, e)
               for m, e in layers)


def expected_assignments(cfg: Dict, traffic: Dict) -> int:
    """Token-expert pairs of one greedy call: every MoE layer over the
    images' prefill (N * P tokens), the regions' prefill (B * S) and each
    of the `decode_steps - 1` decode steps (B)."""
    b = traffic["images"] * traffic["boxes"]
    hf = traffic["image_side"] // 2 ** cfg["vgg_stages"]
    tokens = (traffic["images"] * (hf // 2) ** 2
              + b * (1 + cfg["prompt_length"])
              + b * (traffic["decode_steps"] - 1))
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return layers * cfg["num_experts_per_tok"] * tokens


@contextmanager
def record(moe_ops) -> Iterable[List[Tuple[int, int]]]:
    """Inside the block, each dispatch of the program's `moe_ops` module
    appends (rows, experts with rows) to the list it yields. It reads the
    offsets back, a sync a layer: for a replay, never a timed call."""
    real = moe_ops.dispatch
    seen: List[Tuple[int, int]] = []

    def counting(idx, n_experts):
        order, offs = real(idx, n_experts)
        counts = offs.diff(prepend=offs.new_zeros(1))
        seen.append((idx.numel(), int((counts > 0).sum())))
        return order, offs
    moe_ops.dispatch = counting
    try:
        yield seen
    finally:
        moe_ops.dispatch = real
