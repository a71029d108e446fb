"""The port's evidence path against the JAX package, at a tiny size:

- `eval_split_gt` (greedy and beam-3, an image budget, records) and
  `eval_split_rpn` (an image budget, a score threshold, records) on the
  same loader and converted weights: records identical, scores equal
  (mAP within 1e-6, the loss within 1e-5);
- `utils/visualize.py`: `bilinear_upsample` bitwise, `densecap_draw`,
  `generate_caption_vis`, `display_logs` and `display_loss_history`
  pixel for pixel;
- the ViT exporter (`weights.vit_flat_variables`): the JAX encoder's
  flat variables bitwise, and a round trip through `encoder_init`;
- `python -m imagecaptioning_tpu_torch.evidence_run --model gt --device
  cpu` at 20 images and one epoch: the JAX script's artifact names and
  summary keys.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import vg_loader as jax_vg_loader
from imagecaptioning_tpu.eval import dense_eval as jax_eval
from imagecaptioning_tpu.models.backbones.vit import ViTEncoder as JaxViT
from imagecaptioning_tpu.models.densecap import DenseCapRPN as JaxRPN
from imagecaptioning_tpu.models.densecap import GTDenseCaptioner as JaxGT
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu.utils import pretrained as jax_pretrained
from imagecaptioning_tpu.utils import visualize as jax_vis
from imagecaptioning_tpu_torch import evidence_run
from imagecaptioning_tpu_torch.data import synthetic, vg_loader
from imagecaptioning_tpu_torch.eval import dense_eval
from imagecaptioning_tpu_torch.models.backbones.vit import ViTEncoder
from imagecaptioning_tpu_torch.models.densecap import (DenseCapRPN,
                                                       GTDenseCaptioner)
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils import pretrained, visualize, weights
import torch_threads  # noqa: F401  (one torch thread a test process)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _loaders(num_images=12, image_size=64):
    """The learnable VG set, in each package's loader."""
    arrays, info = synthetic.make_learnable_vg_arrays(
        num_images=num_images, image_size=image_size, seed=5)
    jarrays, jinfo = jax_synthetic.make_learnable_vg_arrays(
        num_images=num_images, image_size=image_size, seed=5)
    return (vg_loader.VGDataLoader(arrays=arrays, info=info),
            jax_vg_loader.VGDataLoader(arrays=jarrays, info=jinfo))


@pytest.fixture(scope="module")
def gt_pair():
    loader, jloader = _loaders()
    kw = dict(vocab_size=loader.getVocabSize(),
              seq_length=loader.getSeqLength(), embedding_size=16,
              rnn_size=16, vgg_stages=2)
    jm = JaxGT(use_lstm=True, **kw)
    b0 = next(jloader.padded_batches(0, 2, 4))
    k = jax.random.PRNGKey(0)
    v = jax.jit(partial(jm.init, train=False))(
        {"params": k, "sampling": k},
        jax_vg_loader.normalize_images(b0["image"]),
        jnp.asarray(b0["boxes"]), jnp.asarray(b0["labels"]))
    params = _np(v["params"])
    pm = GTDenseCaptioner(**kw).eval()
    pm.load_state_dict(weights.gt_state_dict_from_jax(params))
    return jm, params, pm, loader, jloader


@pytest.mark.parametrize("use_beam", [False, True])
def test_eval_split_gt_matches_jax(gt_pair, use_beam):
    jm, params, pm, loader, jloader = gt_pair
    args = dict(split=0, batch_size=2, max_regions=4, max_images=4,
                use_beam=use_beam, return_records=True)
    want = jax_eval.eval_split_gt(jm, {"params": params}, jloader, **args)
    got = dense_eval.eval_split_gt(pm, loader, **args)
    assert got["num_images"] == want["num_images"] == 4
    assert got["records"] == want["records"] and len(got["records"]) == 16
    g, w = got["ap_results"], want["ap_results"]
    assert g["map"] == pytest.approx(w["map"], abs=1e-6)
    assert g["ap_breakdown"] == pytest.approx(w["ap_breakdown"], abs=1e-6)
    assert g["meteor"] == w["meteor"] and g["scorer"] == w["scorer"]
    assert got["loss_results"] == pytest.approx(want["loss_results"],
                                                abs=1e-5)
    # without the budget and records, the whole split
    full = dense_eval.eval_split_gt(pm, loader, split=0, batch_size=2,
                                    max_regions=4, use_beam=use_beam)
    assert full["num_images"] == 10 and "records" not in full


def test_eval_split_rpn_matches_jax():
    loader, jloader = _loaders(num_images=10, image_size=32)
    kw = dict(num_pos=8, num_neg=8, test_proposals=20, embedding_size=16,
              rnn_size=16, vgg_stages=2, anchor_sizes=(8.0, 16.0, 32.0),
              anchor_ratios=(0.5, 1.0, 2.0),
              vocab_size=loader.getVocabSize(),
              seq_length=loader.getSeqLength())
    jm = JaxRPN(**kw)
    b0 = next(jloader.padded_batches(0, 1, 4))
    k = jax.random.PRNGKey(0)
    v = jax.jit(partial(jm.init, train=False))(
        {"params": k}, jax_vg_loader.normalize_images(b0["image"]),
        jnp.asarray(b0["boxes"]), jnp.asarray(b0["box_mask"]),
        jnp.asarray(b0["labels"]), rng=k)
    params = _np(v["params"])
    rng = np.random.RandomState(1)
    for name, scale in (("rpn_trans", 0.05), ("box_reg", 0.01)):
        kern = params[name]["kernel"]
        params[name]["kernel"] = (rng.randn(*kern.shape)
                                  * scale).astype(np.float32)
    pm = DenseCapRPN(**kw)
    pm.load_state_dict(weights.rpn_state_dict_from_jax(params))
    # a threshold inside the kept scores' range drops some detections
    kept = []
    for batch in list(loader.padded_batches(0, 1, 4))[:3]:
        with torch.inference_mode():
            _, scores, _, keep = pm.forward_test(vg_loader.normalize_images(
                torch.from_numpy(batch["image"])))
        kept += scores[keep].tolist()
    kept = np.sort(kept)
    i = max(range(len(kept) // 4, 3 * len(kept) // 4),
            key=lambda j: kept[j + 1] - kept[j])    # far from either side
    assert kept[i + 1] - kept[i] > 1e-4
    args = dict(split=0, max_regions=4, max_images=3,
                score_thresh=float(kept[i] + kept[i + 1]) / 2,
                return_records=True)
    want = jax_driver.eval_split_rpn(jm, {"params": params}, jloader,
                                     **args)
    got = dense_driver.eval_split_rpn(pm, loader, **args)
    assert got["num_images"] == want["num_images"] == 3
    assert got["records"] == want["records"] and got["records"]
    g, w = got["ap_results"], want["ap_results"]
    assert g["anchor_assignment"] == w["anchor_assignment"]
    assert g["proposal_recall"] == w["proposal_recall"]
    for key in ("map", "ap_breakdown", "detmap", "det_breakdown"):
        assert g[key] == pytest.approx(w[key], abs=1e-6), key
    assert g["meteor"] == w["meteor"]
    everything = dense_driver.eval_split_rpn(pm, loader, split=0,
                                             max_regions=4, max_images=3,
                                             return_records=True)
    assert len(everything["records"]) > len(got["records"])


# ------------------------------------------------------------ visualize

def test_bilinear_upsample_bitwise():
    rng = np.random.RandomState(0)
    for g, scale in ((7, 32), (14, 16), (3, 5), (1, 4)):
        grid = rng.rand(g, g).astype(np.float32)
        got = visualize.bilinear_upsample(grid, scale)
        want = jax_vis.bilinear_upsample(grid, scale)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_densecap_draw_pixels_identical(tmp_path):
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (80, 96, 3)).astype(np.uint8)
    boxes = np.stack([rng.uniform(0, 96, 15), rng.uniform(0, 80, 15),
                      rng.uniform(2, 60, 15), rng.uniform(2, 60, 15)], -1)
    caps = [f"a red box {i}" for i in range(12)]
    got = visualize.densecap_draw(image, boxes, caps,
                                  str(tmp_path / "port.png"))
    want = jax_vis.densecap_draw(image, boxes, caps,
                                 str(tmp_path / "jax.png"))
    assert np.array_equal(got, want) and not np.array_equal(got, image)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          np.asarray(Image.open(tmp_path / "jax.png")))


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("grid,meteor", [(7, None), (14, 0.25)])
def test_caption_vis_and_curves_pixels_identical(tmp_path, grid, meteor):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(grid)
    image = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    caption = "a smiling person with glasses"
    p = grid * grid + (1 if grid == 14 else 0)      # ViT: a class token
    alphas = rng.rand(5, p).astype(np.float32)
    kw = dict(gt_caption="a happy face", meteor=meteor,
              bleu=None if meteor is None else 0.125)
    got = visualize.generate_caption_vis(image, caption, alphas,
                                         out_dir=str(tmp_path / "port"),
                                         **kw)
    want = jax_vis.generate_caption_vis(image, caption, alphas,
                                        out_dir=str(tmp_path / "jax"), **kw)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.split("/")[-1] == b.split("/")[-1]
        assert np.array_equal(_pixels(a), _pixels(b))
    hist = [{"iter": 10 * i, "loss_results": 3.0 / i,
             "ap_results": {"meteor": 0.1 * i}} for i in range(1, 6)]
    got = visualize.display_logs(hist, "m", out_dir=str(tmp_path / "port"))
    want = jax_vis.display_logs(hist, "m", out_dir=str(tmp_path / "jax"))
    assert np.array_equal(_pixels(got), _pixels(want))
    losses = [{"iter": i, "loss": 1.0 / (i + 1)} for i in range(20)]
    got = visualize.display_loss_history(losses, str(tmp_path / "p.png"))
    want = jax_vis.display_loss_history(losses, str(tmp_path / "j.png"))
    assert np.array_equal(_pixels(got), _pixels(want))


def test_visualize_model_prediction_renders_the_greedy_caption(tmp_path):
    pytest.importorskip("matplotlib")
    from imagecaptioning_tpu_torch.config.configs import \
        get_lstm_attention_config
    from imagecaptioning_tpu_torch.data.synthetic import \
        make_learnable_face2text_arrays
    from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
    from imagecaptioning_tpu_torch.data.transforms import \
        resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.models.captioners import build_model

    arrays, info = make_learnable_face2text_arrays(num_images=4, seed=0)
    vocab = AlexDataLoader(arrays=arrays, info=info).vocab
    cfg = get_lstm_attention_config().replace(
        backbone_stages=(1, 1, 1, 1), embedding_size=16, lstm_size=16,
        compute_dtype="float32")
    model = weights.seeded_init_(build_model(
        cfg, len(info["idx_to_token"]), 12, device="cpu"), 0).eval()
    x = resnet_v2_preprocess(torch.from_numpy(arrays["images"][:2]))
    paths = visualize.visualize_model_prediction(
        model, x, vocab, 12, gt_labels=arrays["labels"][:2],
        out_dir=str(tmp_path), name="vis")
    toks, alphas = api.make_greedy_fn(model, 13, collect_alphas=True)(x)
    caption = vocab.decode_sequence(toks.numpy())[0]
    n = len(caption.split())
    want = visualize.generate_caption_vis(
        x[0].numpy(), caption, alphas[0, :n].numpy(),
        out_dir=str(tmp_path / "want"), name="vis",
        gt_caption=vocab.decode_sequence(arrays["labels"][:2])[0],
        meteor=float(paths[0].split("_M")[1].split("_B")[0]) / 100
        if "_M" in paths[0] else None,
        bleu=float(paths[0].split("_B")[1].rsplit(".", 1)[0]) / 100
        if "_B" in paths[0] else None)
    assert len(paths) == 2 and [p.split("/")[-1] for p in paths] == \
        [p.split("/")[-1] for p in want]
    assert np.array_equal(_pixels(paths[1]), _pixels(want[1]))


# ------------------------------------------------------- the ViT exporter

def test_vit_exporter_is_the_jax_layout_and_round_trips(tmp_path):
    dims = dict(image_size=32, patch_size=16, num_layers=2, num_heads=4,
                hidden_dim=32, mlp_dim=64)
    jm = JaxViT(**dims)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    params = _np(v["params"])
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda a: (a + rng.randn(*a.shape)).astype(np.float32), params)
    flat_jax = jax_pretrained.flatten_tree({"params": params})
    port = ViTEncoder(**dims)
    port.load_state_dict({k[len("x."):]: t for k, t in weights.vit_state_dict(
        params, prefix="x").items()})
    flat = weights.vit_flat_variables(port)
    assert sorted(flat) == sorted(flat_jax)
    for key, a in flat.items():
        b = np.asarray(flat_jax[key])
        assert a.dtype == np.float32 and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    # through encoder_init into a ViT-B captioner's encoder
    from imagecaptioning_tpu_torch.config.configs import get_vitb_config
    from imagecaptioning_tpu_torch.models.captioners import build_model
    npz = tmp_path / "enc.npz"
    np.savez(npz, **flat)
    cfg = get_vitb_config().replace(vit_dims=(32, 16, 2, 4, 32, 64),
                                    embedding_size=32, num_layers=2,
                                    compute_dtype="float32")
    model = weights.seeded_init_(build_model(cfg, 20, 6, device="cpu"), 0)
    pretrained.apply_encoder_init(model, str(npz), "encoder_vit")
    got = model.encoder_vit.state_dict()
    for k, t in port.state_dict().items():
        assert torch.equal(got[k], t), k


# ------------------------------------------------------------ the script

# the JAX script's summary keys (`evidence_run.py` run_gt: train_gt's
# summary without state, model and loader, plus final_test, history and
# truncated)
GT_SUMMARY = {"iters", "max_iter", "final_loss", "best_val_score",
              "best_iter", "loss_file", "result_file", "save_path",
              "final_test", "history", "truncated"}


def test_evidence_run_gt_writes_the_jax_artifacts(tmp_path, capsys,
                                                  monkeypatch):
    # a relative --out: train_gt renames 'gt' anywhere in the paths, as
    # the reference's traingt.py does
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "ev"
    summary = evidence_run.main(["--model", "gt", "--epochs", "1",
                                 "--images", "20", "--device", "cpu",
                                 "--out", "ev"])
    names = {p.name for p in out.iterdir()}
    want = {"summary_gt_learnable_bs4.json",
            "loss_history_gt_finetuned_learnable_bs4.json",
            "results_history_gt_finetuned_learnable_bs4.json",
            "best_model_gt_finetuned_learnable_bs4.ckpt"}
    try:
        import matplotlib  # noqa: F401
        want.add("gt_learnable_bs4.png")
    except ImportError:
        assert "curve PNG skipped" in capsys.readouterr().out
    assert want <= names, names
    with open(out / "summary_gt_learnable_bs4.json") as f:
        saved = json.load(f)
    assert set(saved) == GT_SUMMARY
    assert set(saved["final_test"]) == {"loss_results", "ap_results",
                                        "num_images", "records"}
    assert set(saved["final_test"]["ap_results"]) == {
        "map", "ap_breakdown", "meteor", "scorer"}
    assert saved["history"] == {
        "file": "results_history_gt_finetuned_learnable_bs4.json",
        "evals": 3, "final_eval_iter": 3}
    assert saved["truncated"] is False and saved["max_iter"] == 3
    assert saved["final_test"]["num_images"] == 3
    assert np.isfinite(saved["final_test"]["ap_results"]["map"])
    with open(out / "results_history_gt_finetuned_learnable_bs4.json") as f:
        hist = json.load(f)
    assert [h["iter"] for h in hist] == [1, 2, 3]
    assert set(hist[0]) == {"iter", "loss_results", "ap_results",
                            "num_images", "best_val_score", "best_iter"}
    assert summary["final_test"]["records"] == saved["final_test"]["records"]


# the JAX script's AlexCap summary: the driver's summary without state,
# model and loader, plus history and truncated
CAPTION_SUMMARY = {"iters", "max_iter", "final_loss", "best_val_score",
                   "best_iter", "final_test", "loss_file", "result_file",
                   "save_path", "history", "truncated"}


@pytest.mark.parametrize("model,curves_raise", [("lstm_attention", True),
                                                ("vitb", False)])
def test_evidence_run_alexcap_writes_the_jax_artifacts(
        tmp_path, capsys, monkeypatch, model, curves_raise):
    """`--model lstm_attention` with `display_logs` made to raise, as it
    does without matplotlib (the summary is still written), and `--model
    vitb` (scratch, then its encoder through `encoder_init`): the JAX
    script's artifact names and summary keys."""
    if curves_raise:
        def no_curves(*a, **k):
            raise ImportError("No module named 'matplotlib'")
        monkeypatch.setattr(visualize, "display_logs", no_curves)
    evidence_run.main(["--model", model, "--epochs", "1", "--images", "20",
                       "--batch-size", "3", "--device", "cpu",
                       "--out", str(tmp_path)])
    tags = ([f"{model}_learnable_bs3"] if model != "vitb" else
            [f"vitb_{k}_learnable_bs3" for k in ("scratch", "pretrained")])
    want = set()
    for tag in tags:
        want |= {f"summary_{tag}.json", f"loss_history_{tag}.json",
                 f"results_history_{tag}.json", f"best_model_{tag}.ckpt",
                 f"vis_{tag}.jpg", f"vis_{tag}_attention.jpg"}
        if not curves_raise:
            want.add(f"{tag}.png")
    if model == "vitb":
        want.add("vitb_encoder_pretrained.npz")
    assert {p.name for p in tmp_path.iterdir()} == want
    assert ("curves skipped: No module named 'matplotlib'"
            in capsys.readouterr().out) == curves_raise
    for tag in tags:
        with open(tmp_path / f"summary_{tag}.json") as f:
            saved = json.load(f)
        assert set(saved) == CAPTION_SUMMARY
        assert set(saved["final_test"]) == {"greedy", *(
            f"beam_{k}" for k in range(1, 6))}
        assert saved["final_test"]["greedy"]["num_images"] == 3
        assert saved["history"] == {
            "file": f"results_history_{tag}.json", "evals": 1,
            "final_eval_iter": 4}
        assert saved["truncated"] is False
