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

All three entries are differentiable with respect to the features AND the
boxes, as the JAX kernels' custom_vjp `_bbwd` / `_bwd` (`roi_align.py:
155-165, 234-242`) are: a `torch.autograd.Function` saves both, and its
backward returns d_features in the features' dtype and d_boxes (fp32),
each only where autograd asks for it. On a CUDA tensor each is one launch
of a hand-written kernel (`csrc/roi_align_bwd.cu`), through
`roi_align_bwd_features` / `roi_align_bwd_boxes`, each with its own
`launches` count; on a CPU tensor they run the plain backward,
`roi_align_backward_reference` (`torch.autograd.grad` through the plain
forward, as `_bbwd` takes `jax.vjp` of the einsum form). Under
`torch.no_grad()` nothing is saved and the forward is its one launch.
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
          image_hw: Tuple[float, float], out_hw: Tuple[int, int],
          counter) -> torch.Tensor:
    """The NHWC pooling: the plain version on the CPU, else one launch
    counted on `counter` (the public wrapper that was called)."""
    if features.device.type == "cpu":
        return roi_align_batch_reference(features, boxes, image_hw, out_hw)
    n, r = boxes.shape[:2]
    out = torch.empty((n, r, *out_hw, features.shape[-1]),
                      dtype=torch.float32, device=features.device)
    _launch("roi_align_fwd", features, boxes, image_hw, out_hw, out)
    counter.launches += 1
    return out


def _chw(features: torch.Tensor, boxes: torch.Tensor,
         image_hw: Tuple[float, float], out_hw: Tuple[int, int],
         out_dtype: torch.dtype) -> torch.Tensor:
    """The fused CHW pooling: the plain version on the CPU, else one
    launch."""
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


def _backward(ctx, grad: torch.Tensor):
    """(d_features, d_boxes) for what autograd asks, None elsewhere."""
    features, boxes = ctx.saved_tensors
    need_features, need_boxes = ctx.needs_input_grad[:2]
    grad = grad.contiguous()
    args = (features, boxes, grad, *ctx.geometry)
    return (roi_align_bwd_features(*args) if need_features else None,
            roi_align_bwd_boxes(*args) if need_boxes else None)


class _PoolNhwc(torch.autograd.Function):
    """`roi_align_batch` / `roi_align` with `_bbwd`'s backward."""

    @staticmethod
    def forward(ctx, features, boxes, image_hw, out_hw, counter):
        ctx.save_for_backward(features, boxes)
        ctx.geometry = (image_hw, out_hw)
        return _nhwc(features, boxes, image_hw, out_hw, counter)

    @staticmethod
    def backward(ctx, grad):
        return (*_backward(ctx, grad), None, None, None)


class _PoolChw(torch.autograd.Function):
    """`roi_align_batch_chw` with `_bbwd`'s backward, taking fc6's
    gradient in CHW order."""

    @staticmethod
    def forward(ctx, features, boxes, image_hw, out_hw, out_dtype):
        ctx.save_for_backward(features, boxes)
        ctx.geometry = (image_hw, out_hw)
        return _chw(features, boxes, image_hw, out_hw, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        return (*_backward(ctx, grad), None, None, None)


def roi_align_batch(features: torch.Tensor, boxes: torch.Tensor,
                    image_hw: Tuple[float, float],
                    out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """features (N, Hf, Wf, C) fp32 or bf16 contiguous, boxes (N, R, 4)
    fp32 xcycwh in image coords → (N, R, oh, ow, C) fp32."""
    _check(features, boxes, out_hw)
    return _PoolNhwc.apply(features, boxes, image_hw, out_hw,
                           roi_align_batch)


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
    return _PoolNhwc.apply(features, boxes, image_hw, out_hw, roi_align)[0]


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
    return _PoolChw.apply(features, boxes, image_hw, out_hw, out_dtype)


roi_align_batch_chw.launches = 0


# ------------------------------------------------------------ backward

def _grad_nhwc(grad: torch.Tensor, features: torch.Tensor,
               boxes: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The upstream gradient as (N, R, oh, ow, C): NHWC as it is, or the
    CHW-flattened (N, R, C·oh·ow) unflattened; raises on any other
    shape, type or device."""
    n, r = boxes.shape[:2]
    c = features.shape[-1]
    oh, ow = out_hw
    if grad.dtype not in _DTYPES:
        raise TypeError(f"want a float32 or bfloat16 gradient, got "
                        f"{grad.dtype}")
    if grad.device != features.device:
        raise ValueError(f"gradient on {grad.device}, features on "
                         f"{features.device}")
    if not grad.is_contiguous():
        raise ValueError("the gradient must be contiguous")
    if tuple(grad.shape) == (n, r, c * oh * ow):
        return grad.reshape(n, r, c, oh, ow).permute(0, 1, 3, 4, 2)
    if tuple(grad.shape) == (n, r, oh, ow, c):
        return grad
    raise ValueError(f"want a gradient ({n}, {r}, {c * oh * ow}) CHW or "
                     f"({n}, {r}, {oh}, {ow}, {c}) NHWC, got "
                     f"{tuple(grad.shape)}")


def roi_align_backward_reference(features: torch.Tensor, boxes: torch.Tensor,
                                 grad: torch.Tensor,
                                 image_hw: Tuple[float, float],
                                 out_hw: Tuple[int, int] = (7, 7),
                                 need_features: bool = True,
                                 need_boxes: bool = True):
    """Plain backward: `torch.autograd.grad` of the plain forward at the
    widened gradient, as `_bbwd` takes `jax.vjp` of the einsum form →
    (d_features in the features' dtype, d_boxes fp32), None for what is
    not needed. `grad` is NHWC (N, R, oh, ow, C) or CHW (N, R, C·oh·ow),
    fp32 or bf16."""
    g = _grad_nhwc(grad, features, boxes, out_hw).float()
    with torch.enable_grad():
        f = features.detach().float().requires_grad_(need_features)
        b = boxes.detach().requires_grad_(need_boxes)
        wanted = [t for t in (f, b) if t.requires_grad]
        if not wanted:
            return None, None
        out = roi_align_batch_reference(f, b, image_hw, out_hw)
        grads = iter(torch.autograd.grad(out, wanted, g))
    d_features = next(grads).to(features.dtype) if need_features else None
    d_boxes = next(grads) if need_boxes else None
    return d_features, d_boxes


def _launch_bwd(entry: str, features: torch.Tensor, boxes: torch.Tensor,
                grad: torch.Tensor, image_hw: Tuple[float, float],
                out_hw: Tuple[int, int], out: torch.Tensor) -> torch.Tensor:
    n, hf, wf, c = features.shape
    oh, ow = out_hw
    shape = (n, boxes.shape[1], hf, wf, c, oh, ow, float(image_hw[0]),
             float(image_hw[1]))
    grad_bf16 = int(grad.dtype == torch.bfloat16)
    grad_chw = int(grad.dim() == 3)
    feat_bf16 = int(features.dtype == torch.bfloat16)
    lib = _kernels.roi_align_bwd_lib()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        if entry == "roi_align_bwd_features":
            err = lib.roi_align_bwd_features(
                grad.data_ptr(), boxes.data_ptr(), out.data_ptr(), *shape,
                grad_bf16, grad_chw, feat_bf16, stream)
        else:
            err = lib.roi_align_bwd_boxes(
                features.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
                out.data_ptr(), *shape, feat_bf16, grad_bf16, grad_chw,
                stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def roi_align_bwd_features(features: torch.Tensor, boxes: torch.Tensor,
                           grad: torch.Tensor, image_hw: Tuple[float, float],
                           out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """d_features (N, Hf, Wf, C) in the features' dtype (summed in fp32,
    rounded once) from the pooling's upstream gradient `grad`, NHWC
    (N, R, oh, ow, C) or CHW (N, R, C·oh·ow), fp32 or bf16. On a CUDA
    tensor one launch of kernel A (`csrc/roi_align_bwd.cu`); on a CPU
    tensor the plain backward."""
    _check(features, boxes, out_hw)
    _grad_nhwc(grad, features, boxes, out_hw)
    if features.device.type == "cpu":
        return roi_align_backward_reference(features, boxes, grad, image_hw,
                                            out_hw, need_boxes=False)[0]
    out = _launch_bwd("roi_align_bwd_features", features, boxes, grad,
                      image_hw, out_hw, torch.empty_like(features))
    roi_align_bwd_features.launches += 1
    return out


roi_align_bwd_features.launches = 0


def roi_align_bwd_boxes(features: torch.Tensor, boxes: torch.Tensor,
                        grad: torch.Tensor, image_hw: Tuple[float, float],
                        out_hw: Tuple[int, int] = (7, 7)) -> torch.Tensor:
    """d_boxes (N, R, 4) fp32 from the pooling's upstream gradient, as
    `roi_align_bwd_features` takes it. On a CUDA tensor one launch of
    kernel B (`csrc/roi_align_bwd.cu`); on a CPU tensor the plain
    backward."""
    _check(features, boxes, out_hw)
    _grad_nhwc(grad, features, boxes, out_hw)
    if features.device.type == "cpu":
        return roi_align_backward_reference(features, boxes, grad, image_hw,
                                            out_hw, need_features=False)[1]
    if sum(out_hw) > 64:
        raise ValueError(f"output {out_hw}: the box kernel takes at most 64 "
                         f"output rows and columns together")
    out = _launch_bwd("roi_align_bwd_boxes", features, boxes, grad, image_hw,
                      out_hw, torch.empty_like(boxes))
    roi_align_bwd_boxes.launches += 1
    return out


roi_align_bwd_boxes.launches = 0
