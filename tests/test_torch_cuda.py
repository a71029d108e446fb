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
bitwise the same on a second launch (neither uses float atomics).
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
