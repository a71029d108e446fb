"""ROI pooling in the PyTorch port against the JAX package's Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU; the
port's side runs its plain version (the wrapper on CPU tensors). Same
numpy inputs from a seed, including boxes hanging off the map, a
full-image box and the (1, 1, 1, 1) pad box. Tolerance: rtol = atol =
1e-5 (fp32; the two sides sum the same taps in the same order, so they
differ by rounding only); for bf16 codes rtol = 2**-7 (bf16 keeps 8
significant bits, so rounding moves a value by at most 2**-8 of it),
atol = 1e-5. The CUDA kernel's own comparison needs the card: it is in
`test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.ops import roi_align as jax_roi
from imagecaptioning_tpu_torch.ops import roi_align as port_roi

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
SHAPES = [
    (3, 9, 8, 8, 4, (128.0, 128.0), (7, 7)),
    (2, 7, 6, 10, 5, (96.0, 160.0), (7, 7)),
    (1, 8, 5, 5, 3, (80.0, 80.0), (3, 4)),
]


def _boxes(rng, n, r, image_hw):
    """(n, r, 4) xcycwh: random boxes plus the edge cases in front."""
    ih, iw = image_hw
    boxes = np.stack([rng.uniform(1, iw, (n, r)), rng.uniform(1, ih, (n, r)),
                      rng.uniform(2, iw / 2, (n, r)),
                      rng.uniform(2, ih / 2, (n, r))], axis=-1)
    edge = np.asarray([
        [(iw + 1) / 2, (ih + 1) / 2, iw, ih],        # full image
        [1.0, ih / 2, iw / 3, ih / 3],                # off the left border
        [iw, ih / 2, iw / 3, ih / 3],                 # off the right border
        [iw / 2, 1.0, iw / 3, ih / 3],                # off the top border
        [iw / 2, ih, iw / 3, ih / 3],                 # off the bottom border
        [iw / 2, ih / 2, 3 * iw, 3 * ih],             # bigger than the image
        [1.0, 1.0, 1.0, 1.0],                         # degenerate pad box
    ])
    k = min(r, len(edge))
    boxes[:, :k] = edge[:k]
    return boxes.astype(np.float32)


@pytest.mark.parametrize("n,r,hf,wf,c,image_hw,out_hw", SHAPES)
def test_batch_matches_pallas_interpret(n, r, hf, wf, c, image_hw, out_hw):
    rng = np.random.RandomState(n * 100 + r)
    feats = rng.randn(n, hf, wf, c).astype(np.float32)
    boxes = _boxes(rng, n, r, image_hw)
    want = np.asarray(jax_roi.roi_align_batch_pallas_fwd(
        jnp.asarray(feats), jnp.asarray(boxes), image_hw, out_hw,
        interpret=True))
    einsum = np.asarray(jax_roi.roi_align_batch(
        jnp.asarray(feats), jnp.asarray(boxes), image_hw, out_hw))
    before = port_roi.roi_align_batch.launches
    got = port_roi.roi_align_batch(torch.from_numpy(feats),
                                   torch.from_numpy(boxes), image_hw, out_hw)
    plain = port_roi.roi_align_batch_reference(
        torch.from_numpy(feats), torch.from_numpy(boxes), image_hw, out_hw)
    assert got.shape == (n, r, *out_hw, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), einsum, **TOL)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # the CPU path never launches the kernel
    assert port_roi.roi_align_batch.launches == before


def test_single_image_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    feat = rng.randn(8, 8, 4).astype(np.float32)
    boxes = _boxes(rng, 1, 9, (128.0, 128.0))[0]
    want = np.asarray(jax_roi.roi_align_pallas_fwd(
        jnp.asarray(feat), jnp.asarray(boxes), (128.0, 128.0),
        interpret=True))
    before = port_roi.roi_align.launches
    got = port_roi.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                             (128.0, 128.0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert port_roi.roi_align.launches == before


def test_roi_weights_match_jax():
    rng = np.random.RandomState(6)
    boxes = _boxes(rng, 1, 12, (192.0, 256.0))[0]
    want = jax_roi.roi_weights(jnp.asarray(boxes), (192.0, 256.0),
                               (12, 16), (7, 7))
    got = port_roi.roi_weights(torch.from_numpy(boxes), (192.0, 256.0),
                               (12, 16), (7, 7))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,hf,wf,c,image_hw,out_hw", SHAPES)
def test_chw_matches_pallas_interpret(n, r, hf, wf, c, image_hw, out_hw,
                                      out_dtype):
    """The fused entry (fc6's input) against K1 reordered HWC → CHW."""
    rng = np.random.RandomState(n * 100 + r)
    feats = rng.randn(n, hf, wf, c).astype(np.float32)
    boxes = _boxes(rng, n, r, image_hw)
    want = np.asarray(jax_roi.roi_align_batch_pallas_fwd(
        jnp.asarray(feats), jnp.asarray(boxes), image_hw, out_hw,
        interpret=True)).transpose(0, 1, 4, 2, 3).reshape(n, r, -1)
    f, b = torch.from_numpy(feats), torch.from_numpy(boxes)
    before = port_roi.roi_align_batch_chw.launches
    got = port_roi.roi_align_batch_chw(f, b, image_hw, out_hw, out_dtype)
    assert got.shape == (n, r, c * out_hw[0] * out_hw[1])
    assert got.dtype == out_dtype
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(TOL if out_dtype == torch.float32
                                  else BF16_TOL))
    # bf16 codes are the fp32 codes rounded once (to nearest even)
    fp32 = port_roi.roi_align_batch_chw(f, b, image_hw, out_hw)
    assert torch.equal(got, fp32.to(out_dtype))
    # bf16 features are widened exactly: the fp32 result on feats.float()
    half = f.to(torch.bfloat16)
    assert torch.equal(
        port_roi.roi_align_batch_chw(half, b, image_hw, out_hw, out_dtype),
        port_roi.roi_align_batch_chw(half.float(), b, image_hw, out_hw,
                                     out_dtype))
    assert torch.equal(port_roi.roi_align_batch(half, b, image_hw, out_hw),
                       port_roi.roi_align_batch(half.float(), b, image_hw,
                                                out_hw))
    # the CPU path never launches the kernel
    assert port_roi.roi_align_batch_chw.launches == before


@pytest.mark.parametrize("features,boxes,kw,err", [
    (torch.zeros(2, 4, 4, 3, dtype=torch.float64), torch.ones(2, 3, 4), {},
     TypeError),
    (torch.zeros(2, 4, 4, 3, dtype=torch.float16), torch.ones(2, 3, 4), {},
     TypeError),
    (torch.zeros(2, 4, 4, 3), torch.ones(2, 3, 4),
     {"out_dtype": torch.float16}, TypeError),
    (torch.zeros(2, 4, 4, 3), torch.ones(1, 3, 4), {}, ValueError),
    (torch.zeros(2, 4, 4, 3), torch.ones(2, 3, 5), {}, ValueError),
    (torch.zeros(2, 3, 4, 4).permute(0, 2, 3, 1), torch.ones(2, 3, 4), {},
     ValueError),
    (torch.zeros(2, 4, 8, 3)[:, :, ::2], torch.ones(2, 3, 4), {},
     ValueError),
    # 90,000 boxes × 512 channels × 7 × 7 outputs overflow int32
    (torch.zeros(1, 1, 1, 512), torch.ones(1, 90000, 4), {}, ValueError),
    # more boxes per image than the kernel's grid takes
    (torch.zeros(1, 1, 1, 1), torch.ones(1, 70000, 4), {}, ValueError),
])
def test_wrapper_rejects_bad_inputs(features, boxes, kw, err):
    with pytest.raises(err):
        port_roi.roi_align_batch_chw(features, boxes, (64.0, 64.0), **kw)
    if not kw:
        with pytest.raises(err):
            port_roi.roi_align_batch(features, boxes, (64.0, 64.0))
