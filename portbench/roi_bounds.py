"""The least time the card could take for each ROI kernel's work: each
input byte read once and each output byte written once at the H100's
published 3.35 TB/s, against its float32 operations at 67 TFLOP/s, the
larger of the two (frozen from the kernel checks' arithmetic of the
program's smoke script).

Operations: the forward's 6 a pooled output (four taps, weighted); kernel
A's 8 a gradient element (4 FMAs); kernel B's 14 (two tap differences,
two weighted sums and two FMAs).
"""

from __future__ import annotations

from typing import Dict

from portbench.peaks import PEAKS

HBM_BYTES_PER_S = PEAKS["H100"]["hbm_bytes_per_s"]
FP32_FLOPS = PEAKS["H100"]["fp32_flops"]


def bound_ms(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def forward(n: int, r: int, hf: int, wf: int, c: int, feat_bytes: int,
            out_bytes: int, oh: int = 7, ow: int = 7) -> float:
    """K1: features and boxes in, the pooled codes out."""
    out = n * r * c * oh * ow
    nbytes = n * hf * wf * c * feat_bytes + n * r * 16 + out * out_bytes
    return bound_ms(nbytes, 6 * out)


def backward_features(n: int, r: int, hf: int, wf: int, c: int,
                      grad_bytes: int, feat_bytes: int, oh: int = 7,
                      ow: int = 7) -> float:
    """Kernel A: the codes' gradient and the boxes in, the map's gradient
    (in the map's type) out."""
    grad = n * r * c * oh * ow
    nbytes = grad * grad_bytes + n * r * 16 + n * hf * wf * c * feat_bytes
    return bound_ms(nbytes, 8 * grad)


def backward_boxes(n: int, r: int, hf: int, wf: int, c: int,
                   grad_bytes: int, feat_bytes: int, oh: int = 7,
                   ow: int = 7) -> float:
    """Kernel B: the map, the boxes and the codes' gradient in, the boxes'
    gradient (float32) out."""
    grad = n * r * c * oh * ow
    nbytes = (n * hf * wf * c * feat_bytes + n * r * 16 + grad * grad_bytes
              + n * r * 16)
    return bound_ms(nbytes, 14 * grad)


# kernel -> a substring of its device name in a profiler trace
KERNELS = {"K1": "roi_align_kernel", "A": "roi_bwd_features",
           "B": "roi_bwd_boxes"}


def per_launch(kind: str, n: int, r: int, hf: int, wf: int, c: int,
               elem_bytes: int) -> Dict[str, float]:
    """Each ROI kernel's bound ms per launch for a path whose map, codes
    and gradients are all `elem_bytes` wide: the forward alone for
    serving, K1, A and B for training."""
    out = {"K1": forward(n, r, hf, wf, c, elem_bytes, elem_bytes)}
    if kind == "train":
        out["A"] = backward_features(n, r, hf, wf, c, elem_bytes, elem_bytes)
        out["B"] = backward_boxes(n, r, hf, wf, c, elem_bytes, elem_bytes)
    return out
