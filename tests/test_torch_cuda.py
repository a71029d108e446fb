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
(fp32 with TF32 off; cuDNN and cuBLAS sum in another order).
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
