"""Bilinear ROI pooling — port of `imagecaptioning_tpu/ops/roi_align.py`.

Semantics match torch `affine_grid/grid_sample(align_corners=False,
padding_mode='zeros')` with θ from the reference's BoxToAffine
(`DenseCap/densecap/BoxToAffine.py:40-43`): θ_t = (2c − 1 − S)/(S − 1),
θ_s = s/S, boxes xcycwh in 1-indexed image coordinates, features NHWC.

- `roi_align_batch` / `roi_align`: the JAX kernels' interface, fp32
  (N, R, oh, ow, C). On a CUDA tensor they launch the hand-written
  kernel `csrc/roi_align.cu` (which replaces the TPU kernels
  `roi_align_batch_pallas_fwd` and, as its N=1 call,
  `roi_align_pallas_fwd`); on a CPU tensor they run the plain version.
  Any other device raises.
- `roi_align_batch_chw`: the same kernel with its fused epilogue, which
  writes the VGG classifier's input, (N, R, C·oh·ow) CHW-flattened, in
  fp32 or bf16. The GT captioner serves through it.
- Features may be fp32 or bf16 (widened exactly, as JAX's
  `astype(float32)`); boxes are fp32. Each wrapper keeps a count of its
  kernel launches in its `launches` attribute.
- `roi_weights` / `roi_align_batch_reference` /
  `roi_align_batch_chw_reference`: the plain PyTorch versions — the JAX
  package's einsum form (`roi_align.py:40-87, 171-177`). The CPU tests
  and the on-card comparison use them; the card's main path does not.

Forward only: the backward (features AND boxes, as `_bbwd` keeps) is the
training slice's `torch.autograd.Function`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from imagecaptioning_tpu_torch.ops import _kernels


def _interp_weights(centers: torch.Tensor, scales: torch.Tensor,
                    out_size: int, in_size: int, image_size: float):
    """Per-box bilinear weight matrix (B, out_size, in_size): output index
    j samples feature pixel p_j = ((θ_s·g_j + θ_t + 1)·in − 1)/2 with
    g_j = (2j + 1)/out − 1; row j holds (1 − frac) at floor(p_j) and frac
    at floor(p_j) + 1, zero outside [0, in)."""
    dev = centers.device

    def div(x, d):
        # divide by a device tensor: on CUDA, PyTorch turns division by a
        # Python scalar into a multiply by its reciprocal, an ulp off the
        # correctly rounded quotient that JAX and the kernel compute
        return x / torch.tensor(d, dtype=torch.float32, device=dev)

    theta_t = div(2.0 * centers - 1.0 - image_size, image_size - 1.0)
    theta_s = div(scales, image_size)
    j = div(2.0 * torch.arange(out_size, dtype=torch.float32, device=dev)
            + 1.0, out_size) - 1.0
    u = theta_s[:, None] * j[None, :] + theta_t[:, None]       # (B, out)
    p = div((u + 1.0) * in_size - 1.0, 2.0)
    p0 = torch.floor(p)
    frac = p - p0
    idx = torch.arange(in_size, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w_lo = torch.where(idx[None, None, :] == p0[..., None],
                       1.0 - frac[..., None], zero)
    w_hi = torch.where(idx[None, None, :] == p0[..., None] + 1.0,
                       frac[..., None], zero)
    return w_lo + w_hi


def roi_weights(boxes: torch.Tensor, image_hw: Tuple[float, float],
                feat_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """boxes (B, 4) xcycwh → (Ry (B, oh, Hf), Cx (B, ow, Wf))."""
    ih, iw = image_hw
    fh, fw = feat_hw
    oh, ow = out_hw
    xc, yc, w, h = boxes.unbind(-1)
    return (_interp_weights(yc, h, oh, fh, float(ih)),
            _interp_weights(xc, w, ow, fw, float(iw)))


def roi_align_batch_reference(features: torch.Tensor, boxes: torch.Tensor,
                              image_hw: Tuple[float, float],
                              out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """Plain version: features (N, Hf, Wf, C), boxes (N, R, 4) →
    (N, R, oh, ow, C) fp32, as two einsums over the dense weights."""
    n, hf, wf, _ = features.shape
    r = boxes.shape[1]
    oh, ow = out_hw
    ry, cx = roi_weights(boxes.reshape(n * r, 4).float(), image_hw,
                         (hf, wf), out_hw)
    ry = ry.reshape(n, r, oh, hf)
    cx = cx.reshape(n, r, ow, wf)
    tmp = torch.einsum("nryh,nhwc->nrywc", ry, features.float())
    return torch.einsum("nrxw,nrywc->nryxc", cx, tmp)


_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1
_GRID_MAX = 65535


def _check(features: torch.Tensor, boxes: torch.Tensor,
           out_hw: Tuple[int, int]) -> None:
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"want features (N, Hf, Wf, C) and boxes (N, R, 4), "
                         f"got {tuple(features.shape)} and {tuple(boxes.shape)}")
    if boxes.shape[0] != features.shape[0]:
        raise ValueError(f"{features.shape[0]} feature maps but "
                         f"{boxes.shape[0]} box slabs")
    if features.dtype not in _DTYPES or boxes.dtype != torch.float32:
        raise TypeError(f"want float32 or bfloat16 features and float32 "
                        f"boxes, got {features.dtype} and {boxes.dtype}")
    if features.device != boxes.device:
        raise ValueError(f"features on {features.device}, boxes on "
                         f"{boxes.device}")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {features.device}")
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("features and boxes must be contiguous "
                         "(NHWC features, (N, R, 4) boxes)")
    n, _, _, c = features.shape
    r = boxes.shape[1]
    n_out = n * r * c * out_hw[0] * out_hw[1]
    if max(features.numel(), n_out) > _INT32_MAX:
        raise ValueError(f"{features.numel()} feature and {n_out} output "
                         f"elements: the kernel indexes in int32")
    if max(n, r) > _GRID_MAX:
        raise ValueError(f"{n} images of {r} boxes: the kernel's grid takes "
                         f"at most {_GRID_MAX} of each")


def _launch(entry: str, features: torch.Tensor, boxes: torch.Tensor,
            image_hw: Tuple[float, float], out_hw: Tuple[int, int],
            out: torch.Tensor, *flags: int) -> torch.Tensor:
    n, hf, wf, c = features.shape
    oh, ow = out_hw
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels.roi_align_lib(), entry)(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            n, boxes.shape[1], hf, wf, c, oh, ow, float(image_hw[0]),
            float(image_hw[1]), int(features.dtype == torch.bfloat16),
            *flags, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def _nhwc(features: torch.Tensor, boxes: torch.Tensor,
          image_hw: Tuple[float, float],
          out_hw: Tuple[int, int]) -> torch.Tensor:
    n, r = boxes.shape[:2]
    out = torch.empty((n, r, *out_hw, features.shape[-1]),
                      dtype=torch.float32, device=features.device)
    return _launch("roi_align_fwd", features, boxes, image_hw, out_hw, out)


def roi_align_batch(features: torch.Tensor, boxes: torch.Tensor,
                    image_hw: Tuple[float, float],
                    out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """features (N, Hf, Wf, C) fp32 or bf16 contiguous, boxes (N, R, 4)
    fp32 xcycwh in image coords → (N, R, oh, ow, C) fp32."""
    _check(features, boxes, out_hw)
    if features.device.type == "cpu":
        return roi_align_batch_reference(features, boxes, image_hw, out_hw)
    out = _nhwc(features, boxes, image_hw, out_hw)
    roi_align_batch.launches += 1
    return out


roi_align_batch.launches = 0


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              image_hw: Tuple[float, float],
              out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """Single image: features (Hf, Wf, C), boxes (B, 4) → (B, oh, ow, C).
    The N=1 call of the same kernel (replaces `roi_align_pallas_fwd`)."""
    if features.dim() != 3 or boxes.dim() != 2:
        raise ValueError(f"want features (Hf, Wf, C) and boxes (B, 4), got "
                         f"{tuple(features.shape)} and {tuple(boxes.shape)}")
    features, boxes = features[None], boxes[None]
    _check(features, boxes, out_hw)
    if features.device.type == "cpu":
        return roi_align_batch_reference(features, boxes, image_hw, out_hw)[0]
    out = _nhwc(features, boxes, image_hw, out_hw)[0]
    roi_align.launches += 1
    return out


roi_align.launches = 0


def roi_align_batch_chw_reference(features: torch.Tensor, boxes: torch.Tensor,
                                  image_hw: Tuple[float, float],
                                  out_hw: Tuple[int, int] = (7, 7),
                                  out_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """Plain version of `roi_align_batch_chw`: the plain pooling, flattened
    (C, oh, ow) per box and cast to `out_dtype`."""
    n, r = boxes.shape[:2]
    pooled = roi_align_batch_reference(features.float(), boxes, image_hw,
                                       out_hw)
    return pooled.permute(0, 1, 4, 2, 3).reshape(n, r, -1).to(out_dtype)


def roi_align_batch_chw(features: torch.Tensor, boxes: torch.Tensor,
                        image_hw: Tuple[float, float],
                        out_hw: Tuple[int, int] = (7, 7),
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """The pooling of `roi_align_batch` written as the VGG classifier's
    input: features (N, Hf, Wf, C) fp32 or bf16 contiguous, boxes
    (N, R, 4) → (N, R, C·oh·ow) in `out_dtype` (fp32, or bf16 rounded to
    nearest even), each row flattened in the reference's CHW order."""
    _check(features, boxes, out_hw)
    if out_dtype not in _DTYPES:
        raise TypeError(f"want a float32 or bfloat16 output, got {out_dtype}")
    if features.device.type == "cpu":
        return roi_align_batch_chw_reference(features, boxes, image_hw,
                                             out_hw, out_dtype)
    n, r = boxes.shape[:2]
    out = torch.empty((n, r, features.shape[-1] * out_hw[0] * out_hw[1]),
                      dtype=out_dtype, device=features.device)
    _launch("roi_align_chw_fwd", features, boxes, image_hw, out_hw, out,
            int(out_dtype == torch.bfloat16))
    roi_align_batch_chw.launches += 1
    return out


roi_align_batch_chw.launches = 0
