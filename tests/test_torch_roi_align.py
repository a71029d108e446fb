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

import jax
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


# ------------------------------------------------------------- backward
#
# The port's backward (on CPU tensors, its plain version) against
# `jax.vjp` of the einsum form and against the Pallas kernels' custom_vjp
# (`_bbwd` / `_bwd`, forward in interpret mode), edge boxes included.
# d_features: max-abs ≤ 1e-5 in fp32 (the same sums in another order);
# for a bf16 map both sides round an fp32 sum to bf16, so within one bf16
# ulp. d_boxes: relative ≤ 1e-4, i.e. max |got − want| ≤ 1e-4 · max |want|
# (each component sums thousands of signed products; the two frameworks
# order them differently).

def _within_one_bf16_ulp(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
    return bool((np.abs(g - w) <= np.ldexp(1.0, e - 8)).all())


def _assert_grads(d_f, d_b, want_f, want_b, bf16):
    if bf16:
        assert d_f.dtype == torch.bfloat16
        assert _within_one_bf16_ulp(d_f.float().numpy(),
                                    np.asarray(want_f, np.float32))
    else:
        assert d_f.dtype == torch.float32
        np.testing.assert_allclose(d_f.numpy(), np.asarray(want_f), rtol=0,
                                   atol=1e-5)
    want_b = np.asarray(want_b)
    assert d_b.dtype == torch.float32 and np.abs(want_b).max() > 0
    np.testing.assert_allclose(d_b.numpy(), want_b, rtol=1e-4,
                               atol=1e-4 * np.abs(want_b).max())


def _grad_case(n, r, hf, wf, c, image_hw, out_hw):
    rng = np.random.RandomState(n * 100 + r + 7)
    feats = rng.randn(n, hf, wf, c).astype(np.float32)
    boxes = _boxes(rng, n, r, image_hw)
    g = rng.randn(n, r, *out_hw, c).astype(np.float32)
    return feats, boxes, g


@pytest.mark.parametrize("layout", ["chw", "nhwc"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,r,hf,wf,c,image_hw,out_hw", SHAPES)
def test_backward_matches_jax_vjp(n, r, hf, wf, c, image_hw, out_hw, bf16,
                                  layout):
    feats, boxes, g = _grad_case(n, r, hf, wf, c, image_hw, out_hw)
    dtype = torch.bfloat16 if bf16 else torch.float32
    f = torch.from_numpy(feats).to(dtype)
    if layout == "chw":       # fc6's gradient, in the map's dtype
        grad = torch.from_numpy(g).permute(0, 1, 4, 2, 3).reshape(n, r, -1)
        grad = grad.to(dtype).contiguous()
        g_nhwc = grad.float().reshape(n, r, c, *out_hw).permute(0, 1, 3, 4, 2)
    else:
        grad = g_nhwc = torch.from_numpy(g)
    _, vjp = jax.vjp(lambda a, b: jax_roi.roi_align_batch(a, b, image_hw,
                                                          out_hw),
                     jnp.asarray(f.float().numpy()).astype(
                         jnp.bfloat16 if bf16 else jnp.float32),
                     jnp.asarray(boxes))
    want_f, want_b = vjp(jnp.asarray(g_nhwc.numpy()))
    b = torch.from_numpy(boxes)
    d_f, d_b = port_roi.roi_align_backward_reference(f, b, grad, image_hw,
                                                     out_hw)
    _assert_grads(d_f, d_b, np.asarray(want_f.astype(jnp.float32)), want_b,
                  bf16)
    # the wrappers (CPU: the plain version, no launch) and autograd through
    # the differentiable forward give the same bits
    before = (port_roi.roi_align_bwd_features.launches,
              port_roi.roi_align_bwd_boxes.launches)
    assert torch.equal(port_roi.roi_align_bwd_features(f, b, grad, image_hw,
                                                       out_hw), d_f)
    assert torch.equal(port_roi.roi_align_bwd_boxes(f, b, grad, image_hw,
                                                    out_hw), d_b)
    fa, ba = f.clone().requires_grad_(), b.clone().requires_grad_()
    if layout == "chw":
        out = port_roi.roi_align_batch_chw(fa, ba, image_hw, out_hw, dtype)
    else:
        out = port_roi.roi_align_batch(fa, ba, image_hw, out_hw)
    got_f, got_b = torch.autograd.grad(out, (fa, ba), grad)
    assert torch.equal(got_f, d_f) and torch.equal(got_b, d_b)
    assert (port_roi.roi_align_bwd_features.launches,
            port_roi.roi_align_bwd_boxes.launches) == before


@pytest.mark.parametrize("n,r,hf,wf,c,image_hw,out_hw", SHAPES)
def test_backward_matches_pallas_custom_vjp(n, r, hf, wf, c, image_hw,
                                            out_hw, monkeypatch):
    """Against `roi_align_batch_pallas`' custom_vjp (`_bbwd`), its forward
    in interpret mode; and, at N=1, `roi_align_pallas`' (`_bwd`)."""
    feats, boxes, g = _grad_case(n, r, hf, wf, c, image_hw, out_hw)
    for name in ("roi_align_batch_pallas_fwd", "roi_align_pallas_fwd"):
        orig = getattr(jax_roi, name)
        monkeypatch.setattr(jax_roi, name, lambda *a, _f=orig, **k: _f(
            *a, **{**k, "interpret": True}))
    _, vjp = jax.vjp(lambda a, b: jax_roi.roi_align_batch_pallas(
        a, b, image_hw, out_hw), jnp.asarray(feats), jnp.asarray(boxes))
    want_f, want_b = vjp(jnp.asarray(g))
    f = torch.from_numpy(feats).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    got_f, got_b = torch.autograd.grad(
        port_roi.roi_align_batch(f, b, image_hw, out_hw), (f, b),
        torch.from_numpy(g))
    _assert_grads(got_f, got_b, want_f, want_b, bf16=False)

    _, vjp1 = jax.vjp(lambda a, b: jax_roi.roi_align_pallas(
        a, b, image_hw, out_hw), jnp.asarray(feats[0]),
        jnp.asarray(boxes[0]))
    want_f, want_b = vjp1(jnp.asarray(g[0]))
    f1 = torch.from_numpy(feats[0]).requires_grad_()
    b1 = torch.from_numpy(boxes[0]).requires_grad_()
    got_f, got_b = torch.autograd.grad(
        port_roi.roi_align(f1, b1, image_hw, out_hw), (f1, b1),
        torch.from_numpy(g[0]))
    _assert_grads(got_f, got_b, want_f, want_b, bf16=False)


def test_backward_computes_only_what_autograd_asks():
    feats, boxes, g = _grad_case(*SHAPES[0])
    image_hw, out_hw = SHAPES[0][5:]
    f = torch.from_numpy(feats).requires_grad_()
    b = torch.from_numpy(boxes)                  # data: no gradient wanted
    port_roi.roi_align_batch_chw(f, b, image_hw, out_hw).sum().backward()
    assert f.grad is not None and b.grad is None
    f2, b2 = torch.from_numpy(feats), torch.from_numpy(boxes)
    b2.requires_grad_()
    port_roi.roi_align_batch(f2, b2, image_hw, out_hw).sum().backward()
    assert b2.grad is not None and f2.grad is None
    with torch.no_grad():
        assert not port_roi.roi_align_batch_chw(
            f, b, image_hw, out_hw).requires_grad


@pytest.mark.parametrize("grad", [
    torch.zeros(3, 9, 7, 7, 5),                        # wrong channel count
    torch.zeros(3, 9, 195),                            # wrong CHW width
    torch.zeros(3, 9, 196, dtype=torch.float64),       # wrong type
    torch.zeros(3, 9, 4, 7, 7).permute(0, 1, 3, 4, 2),  # not contiguous
])
def test_backward_wrappers_reject_bad_gradients(grad):
    feats, boxes = torch.zeros(3, 8, 8, 4), torch.ones(3, 9, 4)
    err = TypeError if grad.dtype == torch.float64 else ValueError
    for fn in (port_roi.roi_align_bwd_features, port_roi.roi_align_bwd_boxes):
        with pytest.raises(err):
            fn(feats, boxes, grad, (128.0, 128.0))
