"""Tests of the PyTorch port that need a CUDA card (marker `cuda`).

They skip without a card. On the card, run them without the JAX-side
conftest (the card's machine has no JAX):

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 absolute and relative between the ROI kernel and its
plain version (fp32, same taps; rounding differs by an ulp or so, e.g.
where the plain version divides by a scalar as a multiply by its
reciprocal). bf16 codes of the fused CHW entry: within one bf16 ulp of
the plain version's fp32 codes rounded to bf16 (the two fp32 sums may
differ in the last bit, which can move the rounding by one step). 1e-4
between the tiny model on the card and on the CPU
(fp32 with TF32 off; cuDNN and cuBLAS sum in another order), for either
caption head, with identical greedy and beam-3 tokens.
The ROI backward kernels against the plain backward (autograd through the
plain forward): d_features within 1e-5 max-abs in fp32 and within one
bf16 ulp for a bf16 map (both round an fp32 sum once, in another order);
d_boxes within 1e-4 relative to the largest component; each kernel
bitwise the same on a second launch (neither uses float atomics), also
on the RPN's sampled boxes (repeated negatives, boxes far larger than
the map and partly outside it), at the RPN training shape itself, and
where kernel A's regions are reached by no box. One fp32 RPN train step
on the card against the CPU, from the same weights and sampler keys: each loss
within 1e-4 relative, each weight within 2·lr. The AlexCap LSTM captioner
(a cut ResNet): fp32 logits within 1e-4 of the CPU's with greedy and
beam-3 tokens identical; one fp64 finetune step within 1e-10 in the loss
and 1e-8 in every gradient and BatchNorm statistic (fp64: a seeded ResNet
in training mode amplifies fp32 rounding past any such bound); the
resident store's batches equal to the streaming path's. The ROI backward
at outputs beyond 32 a side or 256 cells (the general kernels) as at 7×7.
The attention-LSTM, Transformer and ViT-B captioners (a cut ResNet, a
2-layer ViT at 224²): fp32 logits and alphas within 1e-4 of the CPU's
with greedy and beam-3 tokens identical; one train step after the
finetune boundary in fp64 for the ResNet families as the LSTM's, and in
fp32 for ViT-B with its encoder frozen (gradients within 1e-4).
Gradient accumulation (2 micro-steps an update): the tiny RPN's averaged
gradient within 1e-4 relative (all but 1 % of each tensor's elements)
and its weights within 2·lr, kernels A and B once a micro-step; the tiny
AlexCap's fp64 averaged gradient and statistics within 1e-8; at 3
micro-steps, the same micro-gradients' means bitwise the CPU's, the
updated weights within an ulp of the weight plus 8 of the lr (torch
Adam's own rounding on each device). A converted ResNet trunk merged by
`encoder_init` on the card: bitwise the CPU load.
"""

import numpy as np
import pytest
import torch

from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.ops import roi_align as port_roi
from imagecaptioning_tpu_torch.utils.weights import seeded_init_

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _boxes(rng, n, r, ih, iw):
    boxes = np.stack([rng.uniform(-iw / 4, iw * 1.25, (n, r)),
                      rng.uniform(-ih / 4, ih * 1.25, (n, r)),
                      rng.uniform(1, iw, (n, r)), rng.uniform(1, ih, (n, r))],
                     axis=-1)
    boxes[:, 0] = [(iw + 1) / 2, (ih + 1) / 2, iw, ih]       # full image
    boxes[:, 1] = [1.0, 1.0, 1.0, 1.0]                       # pad box
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,hf,wf,c,ih,iw,out_hw", [
    (3, 9, 8, 8, 4, 128.0, 128.0, (7, 7)),
    (2, 40, 11, 17, 37, 176.0, 272.0, (5, 9)),
    (8, 32, 16, 16, 512, 512.0, 512.0, (7, 7)),
    (1, 32, 22, 22, 512, 720.0, 720.0, (7, 7)),
])
def test_kernel_matches_plain(card, n, r, hf, wf, c, ih, iw, out_hw):
    rng = np.random.RandomState(n + r + c)
    feats = torch.from_numpy(rng.randn(n, hf, wf, c).astype(np.float32))
    feats, boxes = feats.to(card), _boxes(rng, n, r, ih, iw).to(card)
    before = port_roi.roi_align_batch.launches
    got = port_roi.roi_align_batch(feats, boxes, (ih, iw), out_hw)
    torch.cuda.synchronize()
    assert port_roi.roi_align_batch.launches == before + 1
    want = port_roi.roi_align_batch_reference(feats, boxes, (ih, iw), out_hw)
    torch.testing.assert_close(got, want, **TOL)
    before = port_roi.roi_align.launches
    one = port_roi.roi_align(feats[0], boxes[0], (ih, iw), out_hw)
    assert port_roi.roi_align.launches == before + 1
    torch.testing.assert_close(one, want[0], **TOL)


def _within_one_bf16_ulp(got, want):
    """Elementwise |got - want| <= one bf16 ulp at the larger magnitude."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return (g - w).abs() <= torch.ldexp(torch.ones_like(g), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,hf,wf,c,ih,iw,out_hw", [
    (3, 9, 8, 8, 4, 128.0, 128.0, (7, 7)),
    (2, 40, 11, 17, 37, 176.0, 272.0, (5, 9)),
    (8, 32, 16, 16, 512, 512.0, 512.0, (7, 7)),
    (1, 32, 22, 22, 512, 720.0, 720.0, (7, 7)),
])
def test_chw_kernel_matches_plain(card, n, r, hf, wf, c, ih, iw, out_hw,
                                  feat_dtype, out_dtype):
    rng = np.random.RandomState(n + r + c)
    feats = torch.from_numpy(rng.randn(n, hf, wf, c).astype(np.float32))
    feats = feats.to(card, feat_dtype)
    boxes = _boxes(rng, n, r, ih, iw).to(card)
    before = port_roi.roi_align_batch_chw.launches
    got = port_roi.roi_align_batch_chw(feats, boxes, (ih, iw), out_hw,
                                       out_dtype)
    torch.cuda.synchronize()
    assert port_roi.roi_align_batch_chw.launches == before + 1
    assert got.shape == (n, r, c * out_hw[0] * out_hw[1])
    assert got.dtype == out_dtype
    want = port_roi.roi_align_batch_chw_reference(feats, boxes, (ih, iw),
                                                  out_hw, out_dtype)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert bool(_within_one_bf16_ulp(got, want).all())
    # the NHWC entry takes bf16 features too, and sums the same taps
    nhwc = port_roi.roi_align_batch(feats, boxes, (ih, iw), out_hw)
    chw = nhwc.permute(0, 1, 4, 2, 3).reshape(n, r, -1).to(out_dtype)
    assert torch.equal(got, chw)


@pytest.mark.cuda
def test_wrapper_raises_on_card_inputs_it_cannot_take(card):
    feats = torch.zeros(2, 3, 4, 4, device=card).permute(0, 2, 3, 1)
    with pytest.raises(ValueError):
        port_roi.roi_align_batch(feats, torch.ones(2, 3, 4, device=card),
                                 (64.0, 64.0))
    with pytest.raises(ValueError):
        port_roi.roi_align_batch(torch.zeros(2, 4, 4, 3, device=card),
                                 torch.ones(2, 3, 4), (64.0, 64.0))


@pytest.mark.cuda
def test_tiny_model_on_card_matches_cpu(card):
    kw = dict(vocab_size=24, seq_length=5, embedding_size=16, rnn_size=16,
              vgg_stages=2)
    cpu = seeded_init_(GTDenseCaptioner(**kw).eval(), 0)
    gpu = GTDenseCaptioner(**kw).eval().to(card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    boxes = _boxes(rng, 2, 4, 32.0, 32.0)
    labels = torch.from_numpy(rng.randint(1, 20, (2, 4, 5)))
    with torch.inference_mode():
        want = cpu(images, boxes, labels).logits
        got = gpu(images.to(card), boxes.to(card), labels.to(card)).logits
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    toks = api.make_region_greedy_fn(gpu, 6)(images.to(card), boxes.to(card))
    assert toks.shape == (8, 6)
    assert torch.equal(toks.cpu(),
                       api.make_region_greedy_fn(cpu, 6)(images, boxes))


@pytest.mark.cuda
def test_infer_cli_on_card_matches_cpu(card, tmp_path):
    import json

    from PIL import Image

    from imagecaptioning_tpu_torch import infer
    from imagecaptioning_tpu_torch.ops import roi_align as roi

    model = seeded_init_(GTDenseCaptioner(
        vocab_size=24, seq_length=5, embedding_size=16, rnn_size=16,
        vgg_stages=2), 1)
    torch.save(model.state_dict(), str(tmp_path / "gt.pth"))
    words = [f"w{i}" for i in range(24)]
    (tmp_path / "dicts.json").write_text(json.dumps({
        "token_to_idx": {w: i + 1 for i, w in enumerate(words)},
        "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}))
    (tmp_path / "photos").mkdir()
    rng = np.random.RandomState(2)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (120, 160, 3), dtype=np.uint8)
                        ).save(str(tmp_path / "photos" / f"d{i}.png"))
    args = ["--model-type", "gt", "--ckpt", str(tmp_path / "gt.pth"),
            "--dicts", str(tmp_path / "dicts.json"),
            "--images", str(tmp_path / "photos"), "--seq-length", "5",
            "--max-regions", "4", "--beam", "3", "--set", "vgg_stages=2",
            "input_encoding_size=16", "rnn_size=16", "use_lstm=true",
            "compute_dtype=float32"]
    before = roi.roi_align_batch_chw.launches
    on_card = infer.main(args)                 # default device: the card
    assert roi.roi_align_batch_chw.launches == before + 2
    assert on_card == infer.main(args + ["--device", "cpu"])


BWD_SHAPES = [
    (3, 9, 8, 8, 4, 128.0, 128.0, (7, 7)),
    (2, 40, 11, 17, 37, 176.0, 272.0, (5, 9)),
    # more boxes than one group of taps, more columns than one tile
    (2, 200, 40, 37, 33, 640.0, 592.0, (7, 7)),
    (1, 32, 22, 22, 512, 720.0, 720.0, (7, 7)),      # N=1, the 720² canvas
    (4, 32, 22, 22, 512, 720.0, 720.0, (7, 7)),      # the training shape
    # the redesigned kernels' edges. 9 rows: three bands of 4 feature rows
    # (the last of one), boxes straddling them
    (2, 12, 9, 13, 64, 144.0, 208.0, (7, 7)),
    # 70 columns: three column passes; 70 boxes: three groups of taps, and
    # more kept boxes than one batch of staging buffers; C = 40: a partial
    # channel chunk of 16-byte rows
    (1, 70, 13, 70, 40, 208.0, 1120.0, (7, 7)),
    # a 3×5 map: each box's 7 output rows land on at most 3 feature rows;
    # C = 70: rows that are no multiple of 16 bytes (copied element-wise)
    (2, 16, 3, 5, 70, 96.0, 160.0, (7, 7)),
    # 256 cells: the slabs take more than 48 KB of shared memory
    (2, 10, 12, 12, 24, 192.0, 192.0, (16, 16)),
    # 32 output rows: the row mask's last bit
    (1, 8, 20, 30, 16, 320.0, 480.0, (32, 8)),
    # beyond the staged kernels (more than 32 rows, more than 256 cells,
    # more than 32 columns): the general kernels, chosen by shape; C = 70:
    # a partial 64-channel chunk
    (2, 9, 10, 11, 70, 96.0, 128.0, (33, 2)),
    (2, 9, 10, 11, 24, 96.0, 128.0, (17, 16)),
    (1, 12, 20, 30, 16, 320.0, 480.0, (9, 40)),
    # kernel A's regions of several column warps (`features_tile`): 48
    # boxes reaching most regions, more than a ring's slots; C = 48: one
    # partial 64-channel chunk
    (2, 48, 45, 45, 48, 720.0, 720.0, (7, 7)),
    # one image of 96 boxes over a 45×45 map of 32 channels: one chunk, so
    # the map is cut into many small regions; NHWC through cp.async
    (1, 96, 45, 45, 32, 720.0, 720.0, (7, 7)),
    # 16×16 cells of 512 channels over 23×23 regions: in fp32 two slots do
    # not fit beside the region's sums, so kernel A stages nothing
    (4, 8, 45, 45, 512, 720.0, 720.0, (16, 16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["chw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,hf,wf,c,ih,iw,out_hw", BWD_SHAPES)
def test_backward_kernels_match_plain(card, n, r, hf, wf, c, ih, iw, out_hw,
                                      dtype, layout):
    rng = np.random.RandomState(n + r + c + 1)
    feats = torch.from_numpy(rng.randn(n, hf, wf, c).astype(np.float32))
    feats = feats.to(card, dtype)
    boxes = _boxes(rng, n, r, ih, iw).to(card)
    g = torch.from_numpy(rng.randn(n, r, *out_hw, c).astype(np.float32))
    if layout == "chw":       # fc6's gradient, in the map's dtype
        grad = g.permute(0, 1, 4, 2, 3).reshape(n, r, -1).to(card, dtype)
    else:
        grad = g.to(card)
    hw = (ih, iw)
    counts = (port_roi.roi_align_bwd_features.launches,
              port_roi.roi_align_bwd_boxes.launches)
    d_f = port_roi.roi_align_bwd_features(feats, boxes, grad, hw, out_hw)
    d_b = port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw, out_hw)
    torch.cuda.synchronize()
    assert (port_roi.roi_align_bwd_features.launches,
            port_roi.roi_align_bwd_boxes.launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    want_f, want_b = port_roi.roi_align_backward_reference(feats, boxes, grad,
                                                           hw, out_hw)
    assert d_f.dtype == dtype and d_f.shape == feats.shape
    if dtype == torch.float32:
        torch.testing.assert_close(d_f, want_f, rtol=0, atol=1e-5)
    else:
        assert bool(_within_one_bf16_ulp(d_f, want_f).all())
    torch.testing.assert_close(d_b, want_b, rtol=1e-4,
                               atol=1e-4 * float(want_b.abs().max()))
    assert torch.equal(
        port_roi.roi_align_bwd_features(feats, boxes, grad, hw, out_hw), d_f)
    assert torch.equal(
        port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw, out_hw), d_b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_without_boxes(card, dtype):
    """No boxes: kernel A writes a zero d_F, kernel B an empty d_boxes,
    from either layout of the (empty) gradient."""
    feats = torch.randn(2, 9, 9, 64, device=card).to(dtype)
    boxes = torch.zeros(2, 0, 4, device=card)
    for grad in (torch.zeros(2, 0, 64 * 49, device=card, dtype=dtype),
                 torch.zeros(2, 0, 7, 7, 64, device=card)):
        d_f = port_roi.roi_align_bwd_features(feats, boxes, grad,
                                              (144.0, 144.0))
        d_b = port_roi.roi_align_bwd_boxes(feats, boxes, grad, (144.0, 144.0))
        torch.cuda.synchronize()
        assert d_f.shape == feats.shape and d_f.dtype == dtype
        assert not bool(d_f.any())
        assert d_b.shape == (2, 0, 4)


@pytest.mark.cuda
def test_autograd_through_the_pooling_launches_the_kernels(card):
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(2, 16, 16, 64).astype(np.float32))
    feats = feats.to(card, torch.bfloat16).requires_grad_()
    boxes = _boxes(rng, 2, 8, 512.0, 512.0).to(card)
    counts = (port_roi.roi_align_bwd_features.launches,
              port_roi.roi_align_bwd_boxes.launches)
    codes = port_roi.roi_align_batch_chw(feats, boxes, (512.0, 512.0),
                                         out_dtype=torch.bfloat16)
    (d_f,) = torch.autograd.grad(codes.float().square().sum(), feats)
    torch.cuda.synchronize()
    # the boxes are data: only kernel A runs
    assert (port_roi.roi_align_bwd_features.launches,
            port_roi.roi_align_bwd_boxes.launches) == (counts[0] + 1,
                                                       counts[1])
    want, _ = port_roi.roi_align_backward_reference(
        feats.detach(), boxes, 2 * codes.detach(), (512.0, 512.0),
        need_boxes=False)
    assert bool(_within_one_bf16_ulp(d_f, want).all())
    with torch.no_grad():
        before = port_roi.roi_align_batch_chw.launches
        port_roi.roi_align_batch_chw(feats, boxes, (512.0, 512.0))
        assert port_roi.roi_align_batch_chw.launches == before + 1


@pytest.mark.cuda
def test_tiny_transformer_on_card_matches_cpu(card):
    """The GT transformer head at its default width (E=256, 3 + 3 layers,
    4 heads) over a 2-stage trunk, fp32: teacher-forced logits (NULL pads
    included, so some score rows are fully masked) within 1e-4 of the
    CPU's; greedy and beam-3 tokens identical, beam scores within 1e-4."""
    kw = dict(vocab_size=24, seq_length=5, vgg_stages=2, use_lstm=False)
    cpu = seeded_init_(GTDenseCaptioner(**kw).eval(), 0)
    gpu = GTDenseCaptioner(**kw).eval().to(card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    boxes = _boxes(rng, 2, 4, 32.0, 32.0)
    labels = torch.from_numpy(rng.randint(1, 25, (2, 4, 5)))
    labels[0, 1, 2:] = 0
    labels[1, 2] = 0
    with torch.inference_mode():
        want = cpu(images, boxes, labels).logits
        got = gpu(images.to(card), boxes.to(card), labels.to(card)).logits
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    toks = api.make_region_greedy_fn(gpu, 6)(images.to(card), boxes.to(card))
    assert torch.equal(toks.cpu(),
                       api.make_region_greedy_fn(cpu, 6)(images, boxes))
    beam = api.make_region_beam_fn(gpu, 6, 3)(images.to(card), boxes.to(card))
    beam_cpu = api.make_region_beam_fn(cpu, 6, 3)(images, boxes)
    assert torch.equal(beam.tokens.cpu(), beam_cpu.tokens)
    assert torch.equal(beam.finished.cpu(), beam_cpu.finished)
    torch.testing.assert_close(beam.scores.cpu(), beam_cpu.scores, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("use_lstm", [True, False])
def test_tiny_train_step_on_card_matches_cpu(card, use_lstm):
    """One fp32 train step (Adam, every group moving) from the same weights
    on the card and on the CPU, dropout off on both (the two devices'
    generators draw different masks): the loss within 1e-4 relative; each
    weight within 2·lr (a first Adam update moves a weight by at most lr,
    and a gradient whose sign is inside rounding noise may flip it), at
    most 1e-5 of them more than 1e-7 apart."""
    from imagecaptioning_tpu_torch.config.dense_configs import DenseConfig
    from imagecaptioning_tpu_torch.train import dense_driver as dd

    cfg = DenseConfig(use_lstm=use_lstm, compute_dtype="float32",
                      vgg_stages=3, input_encoding_size=16, rnn_size=16)
    twins = [dd.build_gt_model(cfg, 24, 5, d)
             for d in (torch.device("cpu"), card)]
    twins[1].load_state_dict(seeded_init_(twins[0], 0).state_dict())
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randint(0, 256, (2, 48, 48, 3),
                                          dtype=np.uint8))
    boxes = _boxes(rng, 2, 4, 48.0, 48.0)
    labels = torch.from_numpy(rng.randint(1, 25, (2, 4, 5)))
    mask = torch.ones(2, 4)
    losses = []
    before = port_roi.roi_align_bwd_features.launches
    for model in twins:
        d = next(model.parameters()).device
        model.classifier[2].p = 0.0
        opt = dd.make_dense_optimizer(cfg, model, 0)
        step = dd.make_gt_train_step(model, opt, False,
                                     torch.Generator(d).manual_seed(0))
        losses.append(float(step(images.to(d), boxes.to(d), labels.to(d),
                                 mask.to(d), 1.0)))
    assert port_roi.roi_align_bwd_features.launches == before + 1
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    cpu = dict(twins[0].named_parameters())
    off = total = 0
    for name, p in twins[1].named_parameters():
        d = (p.detach().cpu() - cpu[name].detach()).abs()
        assert float(d.max()) <= 2 * cfg.learning_rate + 1e-7, name
        off += int((d > 1e-7).sum())
        total += d.numel()
    assert off <= 1e-5 * total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_kernels_on_rpn_sampled_boxes(card, dtype):
    """K1's fused entry and kernels A and B on boxes as the RPN samples
    them at 720²: the reference's anchors (up to 724 px) partly outside
    the image, and negatives repeated by the sampler's cycling."""
    from imagecaptioning_tpu_torch.models.densecap import REFERENCE_ANCHORS

    rng = np.random.RandomState(7)
    n, r, hf, c, s = 2, 48, 45, 64, 720.0
    wh = np.asarray(REFERENCE_ANCHORS, np.float32)[rng.randint(0, 12, (n, r))]
    xy = rng.uniform(-40, s + 40, (n, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, wh], -1)
    boxes[:, r // 2:] = boxes[:, r // 2:r // 2 + 4].repeat(6, axis=1)
    boxes = torch.from_numpy(boxes).to(card)
    feats = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32))
    feats = feats.to(card, dtype)
    hw = (s, s)
    codes = port_roi.roi_align_batch_chw(feats, boxes, hw, out_dtype=dtype)
    want = port_roi.roi_align_batch_chw_reference(feats, boxes, hw,
                                                  out_dtype=dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(codes, want, **TOL)
    else:
        assert bool(_within_one_bf16_ulp(codes, want).all())
    grad = torch.from_numpy(rng.randn(*codes.shape).astype(np.float32))
    grad = grad.to(card, dtype)
    d_f = port_roi.roi_align_bwd_features(feats, boxes, grad, hw)
    d_b = port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw)
    want_f, want_b = port_roi.roi_align_backward_reference(feats, boxes,
                                                           grad, hw)
    if dtype == torch.float32:
        torch.testing.assert_close(d_f, want_f, rtol=0, atol=1e-5)
    else:
        assert bool(_within_one_bf16_ulp(d_f, want_f).all())
    torch.testing.assert_close(d_b, want_b, rtol=1e-4,
                               atol=1e-4 * float(want_b.abs().max()))
    assert torch.equal(port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw),
                       d_b)


def _check_backward(card, feats, boxes, grad, hw):
    """Kernels A and B against the plain backward, each bitwise the same
    on a second launch."""
    d_f = port_roi.roi_align_bwd_features(feats, boxes, grad, hw)
    d_b = port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw)
    want_f, want_b = port_roi.roi_align_backward_reference(feats, boxes,
                                                           grad, hw)
    if feats.dtype == torch.float32:
        torch.testing.assert_close(d_f, want_f, rtol=0, atol=1e-5)
    else:
        assert bool(_within_one_bf16_ulp(d_f, want_f).all())
    torch.testing.assert_close(d_b, want_b, rtol=1e-4,
                               atol=1e-4 * float(want_b.abs().max()))
    assert torch.equal(port_roi.roi_align_bwd_features(feats, boxes, grad,
                                                       hw), d_f)
    assert torch.equal(port_roi.roi_align_bwd_boxes(feats, boxes, grad, hw),
                       d_b)
    return d_f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_at_the_rpn_training_shape(card, dtype):
    """Kernels A and B at the RPN training shape (4 images × 256 boxes of
    a 45×45×512 map at 720², CHW gradient in the map's dtype), the boxes
    placed as the RPN samples them: the reference's anchors, some partly
    outside the image, the negatives repeated."""
    from imagecaptioning_tpu_torch.models.densecap import REFERENCE_ANCHORS

    rng = np.random.RandomState(11)
    n, r, hf, c, s = 4, 256, 45, 512, 720.0
    wh = np.asarray(REFERENCE_ANCHORS, np.float32)[rng.randint(0, 12, (n, r))]
    xy = rng.uniform(-40, s + 40, (n, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, wh], -1)
    boxes[:, r // 2:] = boxes[:, r // 2:r // 2 + 16].repeat(8, axis=1)
    boxes = torch.from_numpy(boxes).to(card)
    feats = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32))
    feats = feats.to(card, dtype)
    grad = torch.from_numpy(rng.randn(n, r, c * 49).astype(np.float32))
    _check_backward(card, feats, boxes, grad.to(card, dtype), (s, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_where_no_box_reaches(card, dtype):
    """Small boxes in the top-left quarter of the image only: kernel A's
    regions (row groups, column passes) further right and down are reached
    by no box, and their d_F is zero."""
    rng = np.random.RandomState(12)
    n, r, hf, c, s = 2, 40, 45, 64, 720.0
    boxes = np.stack([rng.uniform(1, s / 4, (n, r)),
                      rng.uniform(1, s / 4, (n, r)),
                      rng.uniform(16, s / 8, (n, r)),
                      rng.uniform(16, s / 8, (n, r))], -1).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(card)
    feats = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32))
    feats = feats.to(card, dtype)
    grad = torch.from_numpy(rng.randn(n, r, c * 49).astype(np.float32))
    d_f = _check_backward(card, feats, boxes, grad.to(card, dtype), (s, s))
    assert not bool(d_f[:, hf // 2:, :].any())
    assert not bool(d_f[:, :, hf // 2:].any())


@pytest.mark.cuda
def test_tiny_rpn_accumulated_update_on_card_matches_cpu(card):
    """Two fp32 RPN micro-steps at grad_accum_steps 2 on the card and on
    the CPU, from the same weights and sampler keys, dropout off: the
    weights bitwise unchanged after the first; the averaged gradient
    before the update within 1e-4 relative to each tensor's largest in
    all but 1 % of its elements; every weight within 2·lr after it;
    kernels A and B launched once a micro-step, twice an update."""
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.train import dense_driver as dd

    cfg = get_densecap_config().replace(
        compute_dtype="float32", vgg_stages=3, input_encoding_size=16,
        rnn_size=16, sampler_batch_size=16, anchor_sizes=(8.0, 16.0, 32.0),
        grad_accum_steps=2)
    twins = [dd.build_rpn_model(cfg, 24, 5, d)
             for d in (torch.device("cpu"), card)]
    twins[1].load_state_dict(seeded_init_(twins[0], 0).state_dict())
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(2):
        boxes = np.stack([rng.uniform(16, 48, (2, 4)),
                          rng.uniform(16, 48, (2, 4)),
                          rng.uniform(8, 32, (2, 4)),
                          rng.uniform(8, 32, (2, 4))], -1)
        batches.append((
            torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3),
                                         dtype=np.uint8)),
            torch.from_numpy(boxes.astype(np.float32)), torch.ones(2, 4),
            torch.from_numpy(rng.randint(1, 25, (2, 4, 5))),
            torch.from_numpy(rng.rand(2, 2, (64 // 8) ** 2 * 9)
                             .astype(np.float32))))
    grads = []
    counters = (port_roi.roi_align_bwd_features, port_roi.roi_align_bwd_boxes)
    before = [c.launches for c in counters]
    for model in twins:
        d = next(model.parameters()).device
        model.recog_base[2].p = 0.0
        opt = dd.make_dense_optimizer(cfg, model, 0)
        seen = {}
        opt.register_step_pre_hook(lambda *_, m=model, g=seen: g.update(
            {n: p.grad.cpu().clone() for n, p in m.named_parameters()
             if p.grad is not None}))
        step = dd.make_rpn_train_step(model, opt,
                                      torch.Generator(d).manual_seed(0))
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        for k, (images, boxes, mask, labels, keys) in enumerate(batches):
            step(images.to(d), boxes.to(d), mask.to(d), labels.to(d),
                 keys=tuple(keys.to(d)))
            if k == 0:
                assert not seen
                for n, p in model.named_parameters():
                    assert torch.equal(p, start[n]), n
        grads.append(seen)
    assert [c.launches for c in counters] == [b + 2 for b in before]
    cpu_grads, card_grads = grads
    assert cpu_grads and sorted(cpu_grads) == sorted(card_grads)
    for name, want in cpu_grads.items():
        w = want.double()
        rel = ((card_grads[name].double() - w).abs()
               / (w.abs() + w.abs().max()).clamp_min(1e-30))
        assert float((rel > 1e-4).double().mean()) <= 0.01, name
    cpu = dict(twins[0].named_parameters())
    for name, p in twins[1].named_parameters():
        d = (p.detach().cpu() - cpu[name].detach()).abs()
        assert float(d.max()) <= 2 * cfg.learning_rate + 1e-7, name


@pytest.mark.cuda
def test_tiny_rpn_train_step_on_card_matches_cpu(card):
    """One fp32 RPN train step on the card and on the CPU, from the same
    weights and the same sampler keys, dropout off: each loss within 1e-4
    relative, each weight within 2·lr, at most 1e-5 of them more than
    1e-7 apart; kernel B launched once, for the sampled boxes."""
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.train import dense_driver as dd

    cfg = get_densecap_config().replace(
        compute_dtype="float32", vgg_stages=3, input_encoding_size=16,
        rnn_size=16, sampler_batch_size=16, anchor_sizes=(8.0, 16.0, 32.0))
    twins = [dd.build_rpn_model(cfg, 24, 5, d)
             for d in (torch.device("cpu"), card)]
    twins[1].load_state_dict(seeded_init_(twins[0], 0).state_dict())
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8))
    boxes = torch.from_numpy(np.stack([
        rng.uniform(16, 48, (2, 4)), rng.uniform(16, 48, (2, 4)),
        rng.uniform(8, 32, (2, 4)), rng.uniform(8, 32, (2, 4))],
        -1).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, 25, (2, 4, 5)))
    mask = torch.ones(2, 4)
    a = (64 // 8) ** 2 * 9        # 3 stages pool 3 times: an 8×8 map
    keys = torch.from_numpy(rng.rand(2, 2, a).astype(np.float32))
    losses = []
    before = port_roi.roi_align_bwd_boxes.launches
    for model in twins:
        d = next(model.parameters()).device
        model.recog_base[2].p = 0.0
        opt = dd.make_dense_optimizer(cfg, model, 0)
        step = dd.make_rpn_train_step(model, opt,
                                      torch.Generator(d).manual_seed(0))
        losses.append({k: float(v) for k, v in step(
            images.to(d), boxes.to(d), mask.to(d), labels.to(d),
            keys=tuple(keys.to(d))).items()})
    assert port_roi.roi_align_bwd_boxes.launches == before + 1
    for k, want in losses[0].items():
        assert abs(losses[1][k] - want) <= 1e-4 * abs(want) + 1e-7, k
    cpu = dict(twins[0].named_parameters())
    off = total = 0
    for name, p in twins[1].named_parameters():
        d = (p.detach().cpu() - cpu[name].detach()).abs()
        assert float(d.max()) <= 2 * cfg.learning_rate + 1e-7, name
        off += int((d > 1e-7).sum())
        total += d.numel()
    assert off <= 1e-5 * total


def _tiny_alexcap(device, dtype=torch.float32):
    from imagecaptioning_tpu_torch.models.captioners import LSTMCaptioner
    model = LSTMCaptioner(30, 16, 16, backbone_stages=(1, 1, 1, 1)).to(device)
    model.features.compute_dtype = dtype
    return model.to(dtype)


@pytest.mark.cuda
def test_tiny_alexcap_on_card_matches_cpu(card):
    """The AlexCap LSTM captioner (ResNet stages 1,1,1,1) in fp32 on the
    card against the CPU on uint8 CelebA-size images, preprocess included:
    teacher-forced logits within 1e-4, greedy and beam-3 tokens
    identical."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    twins = [_tiny_alexcap(d).eval() for d in (torch.device("cpu"), card)]
    twins[1].load_state_dict(seeded_init_(twins[0], 0).state_dict())
    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randint(0, 256, (2, 218, 178, 3),
                                          dtype=np.uint8))
    gt = torch.from_numpy(rng.randint(1, 31, (2, 6)))
    out = []
    for model in twins:
        d = next(model.parameters()).device
        x = resnet_v2_preprocess(images.to(d))
        with torch.no_grad():
            out.append((model(x, gt.to(d)).logits.cpu(),
                        api.make_greedy_fn(model, 7)(x).cpu(),
                        api.make_beam_fn(model, 7, 3)(x).tokens.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(out[1][1], out[0][1])
    assert torch.equal(out[1][2], out[0][2])


def _tiny_alexcap_step(device, dtype, accum=1):
    """One AlexCap finetune update (BatchNorm on batch statistics) in
    `dtype` on `device` from seed 0's weights, from `accum` micro-steps of
    2 images each → (the mean micro-loss, {name: gradient before the
    update}, {name: running statistic after it}), on the CPU."""
    from imagecaptioning_tpu_torch.config.configs import get_lstm_config
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step

    rng = np.random.RandomState(8)
    images = torch.from_numpy(rng.randint(0, 256, (2 * accum, 218, 178, 3),
                                          dtype=np.uint8))
    gt = torch.from_numpy(rng.randint(1, 31, (2 * accum, 6)))
    seeded = seeded_init_(_tiny_alexcap(torch.device("cpu")), 0).state_dict()
    model = _tiny_alexcap(device)
    model.load_state_dict(seeded)
    model.to(dtype)
    model.features.compute_dtype = dtype
    opt = optim.make_optimizer(
        get_lstm_config().replace(grad_accum_steps=accum), model, 10)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.cpu().clone() for n, p in model.named_parameters()}))
    step = make_train_step(
        model, opt, torch.Generator(device).manual_seed(0),
        lambda u8: resnet_v2_preprocess(u8, dtype=dtype), clip_norm=1.0)
    loss = float(np.mean([float(step(images[i:i + 2].to(device),
                                     gt[i:i + 2].to(device))["loss"])
                          for i in range(0, 2 * accum, 2)]))
    assert grads and opt.mini_step == 0
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


@pytest.mark.cuda
def test_tiny_alexcap_train_step_on_card_matches_cpu(card):
    """One fp64 AlexCap finetune step (BatchNorm on batch statistics) on
    the card and on the CPU from the same weights and batch: the loss
    within 1e-10 relative, every gradient before the update and
    BatchNorm's running statistics within 1e-8 (fp64: a seeded ResNet in
    training mode amplifies fp32 rounding past any such bound; the fp32
    step is held by the next test)."""
    (loss0, g0, s0), (loss1, g1, s1) = (
        _tiny_alexcap_step(d, torch.float64)
        for d in (torch.device("cpu"), card))
    assert abs(loss1 - loss0) <= 1e-10 * abs(loss0)
    assert sorted(g0) == sorted(g1)
    for name, want in g0.items():
        torch.testing.assert_close(g1[name], want, rtol=1e-8,
                                   atol=1e-8 * float(want.abs().max()),
                                   msg=name)
    for name, want in s0.items():
        torch.testing.assert_close(s1[name], want, rtol=1e-8, atol=1e-10,
                                   msg=name)


@pytest.mark.cuda
def test_tiny_alexcap_accumulated_update_on_card_matches_cpu(card):
    """Two fp64 micro-steps at grad_accum_steps 2 (one applied update) on
    the card and on the CPU: the mean loss within 1e-10 relative, the
    averaged gradient before the update and the running statistics after
    both micro-steps within 1e-8."""
    (loss0, g0, s0), (loss1, g1, s1) = (
        _tiny_alexcap_step(d, torch.float64, accum=2)
        for d in (torch.device("cpu"), card))
    assert abs(loss1 - loss0) <= 1e-10 * abs(loss0)
    assert sorted(g0) == sorted(g1)
    for name, want in g0.items():
        torch.testing.assert_close(g1[name], want, rtol=1e-8,
                                   atol=1e-8 * float(want.abs().max()),
                                   msg=name)
    for name, want in s0.items():
        torch.testing.assert_close(s1[name], want, rtol=1e-8, atol=1e-10,
                                   msg=name)


@pytest.mark.cuda
def test_tiny_alexcap_fp32_train_step_on_card_is_as_close_to_fp64(card):
    """The same step in fp32: the card's gradients and running statistics
    no further from the CPU's fp64 step than twice the CPU's own fp32
    step is, plus 1e-5 relative (‖g − g64‖ ≤ 2‖g_cpu − g64‖ + 1e-5‖g64‖,
    per tensor; chip_smoke.py phase 18's gate); the loss within 1e-5
    relative of the CPU's fp32 loss."""
    cpu = torch.device("cpu")
    loss64, g64, s64 = _tiny_alexcap_step(cpu, torch.float64)
    loss_cpu, g_cpu, s_cpu = _tiny_alexcap_step(cpu, torch.float32)
    loss_card, g_card, s_card = _tiny_alexcap_step(card, torch.float32)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert sorted(g_card) == sorted(g64)
    for got, cpu32, want in ((g_card, g_cpu, g64), (s_card, s_cpu, s64)):
        for name, w in want.items():
            bound = (2 * float((cpu32[name].double() - w).norm())
                     + 1e-5 * float(w.norm()))
            assert float((got[name].double() - w).norm()) <= bound, name


@pytest.mark.cuda
def test_resident_store_on_card_matches_streaming(card):
    """The train split staged on the card, gathered by the index stream,
    gives the streaming path's batches, in order, over two epochs."""
    from imagecaptioning_tpu_torch.config.configs import get_lstm_config
    from imagecaptioning_tpu_torch.data import device_store, synthetic
    from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
    from imagecaptioning_tpu_torch.train import driver

    arrays, info = synthetic.make_face2text_arrays(num_images=20, seed=3)
    loaders = [AlexDataLoader(arrays=arrays, info=info, seed=5)
               for _ in range(2)]
    store = device_store.stage_split(loaders[0], 0, card)
    feed = device_store.index_stream(loaders[0], 0, 3, iterate=False)
    stream = driver._batch_iterator(loaders[1], get_lstm_config(), 3)
    for _ in range(10):
        images, labels = device_store.gather_batch(
            store, torch.from_numpy(next(feed)).to(card))
        want_images, want_labels = next(stream)
        assert np.array_equal(images.cpu().numpy(), want_images)
        assert np.array_equal(labels.cpu().numpy(), want_labels)


# the attention-LSTM, Transformer and ViT-B families at a tiny size
FAMILY_SETS = {
    "lstm_attention": dict(embedding_size=16, lstm_size=16),
    "transformer": dict(transformer_size=32, num_layers=2, num_heads=4),
    "vitb": dict(vit_dims=(224, 16, 2, 2, 32, 64), embedding_size=32,
                 num_layers=2, num_heads=4),
}


def _tiny_family(model_type, device, dtype=torch.float32):
    from imagecaptioning_tpu_torch.config.configs import get_config
    from imagecaptioning_tpu_torch.models.captioners import build_model
    cfg = get_config(model_type).replace(
        backbone_stages=(1, 1, 1, 1), compute_dtype="float32",
        use_dropout=False, **FAMILY_SETS[model_type])
    model = build_model(cfg, 30, 6, device=device)
    model.encoder.compute_dtype = dtype
    return cfg, model.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", list(FAMILY_SETS))
def test_tiny_family_on_card_matches_cpu(card, model_type):
    """A tiny attention-LSTM, Transformer or ViT-B captioner in fp32 on the
    card against the CPU on uint8 CelebA-size images, preprocess included:
    teacher-forced logits and alphas, and the greedy and beam-3 decodes'
    alphas, within 1e-4; greedy and beam-3 tokens identical."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    twins = [_tiny_family(model_type, d)[1].eval()
             for d in (torch.device("cpu"), card)]
    twins[1].load_state_dict(seeded_init_(twins[0], 0).state_dict())
    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randint(0, 256, (2, 218, 178, 3),
                                          dtype=np.uint8))
    gt = torch.from_numpy(rng.randint(1, 31, (2, 6)))
    out = []
    for model in twins:
        d = next(model.parameters()).device
        x = resnet_v2_preprocess(images.to(d))
        with torch.no_grad():
            tf = model(x, gt.to(d))
            toks, alphas = api.make_greedy_fn(model, 7,
                                              collect_alphas=True)(x)
            beam = api.make_beam_fn(model, 7, 3, collect_alphas=True)(x)
        out.append([t.cpu() for t in (tf.logits, tf.alphas, alphas,
                                      beam.alphas, toks, beam.tokens)])
    for got, want in zip(out[1][:4], out[0][:4]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(out[1][4], out[0][4])
    assert torch.equal(out[1][5], out[0][5])


def _tiny_family_step(model_type, device, dtype):
    """One train step after the finetune boundary (a `trained_encoder`
    ViT's encoder frozen) in `dtype` on `device` from seed 0's weights →
    (loss, {name: gradient before the update}, {name: running statistic
    after it}), on the CPU."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step

    rng = np.random.RandomState(8)
    images = torch.from_numpy(rng.randint(0, 256, (2, 218, 178, 3),
                                          dtype=np.uint8))
    gt = torch.from_numpy(rng.randint(1, 31, (2, 6)))
    seeded = seeded_init_(_tiny_family(model_type, torch.device("cpu"))[1],
                          0).state_dict()
    cfg, model = _tiny_family(model_type, device, dtype)
    model.load_state_dict(seeded)
    opt = optim.make_optimizer(cfg, model, 10)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.cpu().clone() for n, p in model.named_parameters()
         if p.grad is not None}))
    step = make_train_step(
        model, opt, torch.Generator(device).manual_seed(0),
        lambda u8: resnet_v2_preprocess(u8, dtype=dtype), clip_norm=1.0)
    loss = float(step(images.to(device), gt.to(device))["loss"])
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", list(FAMILY_SETS))
def test_tiny_family_train_step_on_card_matches_cpu(card, model_type):
    """One train step after the finetune boundary on the card and on the
    CPU from the same weights and batch: the ResNet families in fp64 (the
    loss within 1e-10 relative, every gradient and running statistic
    within 1e-8, as the LSTM's fp64 test), ViT-B with its encoder frozen
    in fp32 (the loss within 1e-5 relative, every gradient within 1e-4 of
    its tensor's largest); the attention score bias's gradient, zero but
    for rounding, within the same bound of the step's largest."""
    f64 = model_type != "vitb"
    dtype, tol = (torch.float64, 1e-8) if f64 else (torch.float32, 1e-4)
    (loss0, g0, s0), (loss1, g1, s1) = (
        _tiny_family_step(model_type, d, dtype)
        for d in (torch.device("cpu"), card))
    assert abs(loss1 - loss0) <= (1e-10 if f64 else 1e-5) * abs(loss0)
    assert sorted(g0) == sorted(g1) and g0
    largest = max(float(w.abs().max()) for w in g0.values())
    for name, want in g0.items():
        if name == "llm.attention.v.bias":
            # the softmax over positions ignores a shift of every score:
            # zero but for rounding on both sides
            assert max(float(g1[name].abs().max()),
                       float(want.abs().max())) <= tol * largest
            continue
        torch.testing.assert_close(g1[name], want, rtol=tol,
                                   atol=tol * float(want.abs().max()),
                                   msg=name)
    for name, want in s0.items():
        torch.testing.assert_close(s1[name], want, rtol=1e-8, atol=1e-10,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("use_beam", [False, True])
def test_tiny_eval_split_gt_on_card_matches_cpu(card, use_beam):
    """`eval_split_gt` (greedy, or beam-3 with an image budget and records)
    of a tiny fp32 GT model on the card against the CPU on the learnable
    VG set: the same records, hence the same captions, and the same
    scores."""
    from imagecaptioning_tpu_torch.data import synthetic
    from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
    from imagecaptioning_tpu_torch.eval import dense_eval

    arrays, info = synthetic.make_learnable_vg_arrays(num_images=12,
                                                      image_size=64)
    loader = VGDataLoader(arrays=arrays, info=info)
    kw = dict(vocab_size=loader.getVocabSize(),
              seq_length=loader.getSeqLength(), embedding_size=16,
              rnn_size=16, vgg_stages=2)
    cpu = seeded_init_(GTDenseCaptioner(**kw).eval(), 0)
    gpu = GTDenseCaptioner(**kw).eval().to(card)
    gpu.load_state_dict(cpu.state_dict())
    args = dict(split=0, batch_size=2, max_regions=4, max_images=4,
                use_beam=use_beam, return_records=True)
    want = dense_eval.eval_split_gt(cpu, loader, **args)
    got = dense_eval.eval_split_gt(gpu, loader, **args)
    assert got["num_images"] == want["num_images"] == 4
    assert got["records"] == want["records"] and got["records"]
    assert got["ap_results"]["map"] == want["ap_results"]["map"]
    assert got["ap_results"]["meteor"] == want["ap_results"]["meteor"]
    assert got["loss_results"] == pytest.approx(want["loss_results"],
                                                rel=1e-4)


@pytest.mark.cuda
def test_k3_accumulated_update_on_card_is_the_cpus_bitwise(card):
    """At grad_accum_steps 3 the running means divide by 2 and 3 (1/3 has
    no exact reciprocal, which CUDA would multiply by for a Python
    divisor): the card's means equal the CPU's bit for bit, from the same
    micro-gradients. The updated weights are torch Adam's on each device,
    which round apart whatever k is (the card's foreach kernels against
    the CPU's one tensor at a time; at k = 1 too): each within one ulp of
    the weight plus 8 ulps of the lr, the update's own roundings (measured
    on an H100: 1.3 % of the weights differ, by at most one ulp of the
    weight plus 2.8 ulps of the lr)."""
    from imagecaptioning_tpu_torch.tools.accum_check import (
        accumulated_update)
    (m0, w0), (m1, w1) = (accumulated_update(d, 3) for d in (
        torch.device("cpu"), card))
    assert sorted(m0) == sorted(m1) and sorted(w0) == sorted(w1)
    for name in m0:
        assert torch.equal(m1[name], m0[name]), name
    lr_ulp = float(np.spacing(np.float32(1e-4)))      # get_lstm_config's lr
    for name in w0:
        torch.testing.assert_close(w1[name], w0[name], rtol=2.0 ** -23,
                                   atol=8 * lr_ulp, msg=name)


@pytest.mark.cuda
def test_converted_encoder_init_on_card_is_the_cpus_bitwise(card, tmp_path):
    """A torchvision-layout ResNet (cut to one block a stage) converted by
    `torch_port.convert_resnet` and merged by `encoder_init` into a model
    on the card: every tensor equals the CPU load's and the source's."""
    from imagecaptioning_tpu_torch.utils import torch_port as tp
    from imagecaptioning_tpu_torch.utils.pretrained import (
        apply_encoder_init, flatten_tree)
    src = seeded_init_(_tiny_alexcap(torch.device("cpu")), 0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():       # BatchNorm's scales, shifts and statistics
        for t in [*src.features.parameters(), *src.features.buffers()]:
            if t.dim() == 1 and t.dtype.is_floating_point:
                t.uniform_(0.5, 1.5, generator=gen)
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
             "6": "layer3", "7": "layer4"}
    tv = {}
    for k, v in src.features.state_dict().items():
        head, _, tail = k.partition(".")
        tv[f"{names[head]}.{tail}"] = v.numpy()
    npz = str(tmp_path / "r.npz")
    np.savez(npz, **flatten_tree(tp.convert_resnet(tv, stages=(1, 1, 1,
                                                               1))))
    loaded = [apply_encoder_init(seeded_init_(_tiny_alexcap(d), 1), npz,
                                 "features").features.state_dict()
              for d in (torch.device("cpu"), card)]
    want = src.features.state_dict()
    for name, v in want.items():
        assert loaded[1][name].is_cuda, name
        assert torch.equal(loaded[1][name].cpu(), loaded[0][name]), name
        assert torch.equal(loaded[0][name], v), name
