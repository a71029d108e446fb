"""The PyTorch port's RPN training driver, eval and entry point against the
JAX package, at a tiny size (2 VGG stages, 32–64² images, narrow heads).

- `make_dense_optimizer` over the RPN's parameter names against optax
  over 6 updates of fixed gradients (weight decay on, as the GT tests set
  it; the encoder from update 3 on; `conv_trunk`'s conv1/conv2 frozen),
  and `rpn_train_state_from_jax` then one more update: params within
  1e-6;
- `DenseCaptioningEvaluator` and `eval_box_recalls` equal to JAX's on
  fixed records; `eval_split_rpn` equal to JAX's on the same loader and
  weights (mAP, proposal recall, anchor assignment, records);
- `rpn_proposer` within 1e-5 of JAX's; `get_densecap_config` equal;
- the train step (keys and dropout from the trainer's generator),
  `train_DenseCap … --device cpu` for 2 steps with finite losses and a
  resume, with each of `grad_accum_steps`, `encoder_init` and
  `tensorboard_dir`, and the raise without `--device cpu` where there is
  no card.
"""

import json
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecaptioning_tpu.config import dense_configs as jax_configs
from imagecaptioning_tpu.data import proposals as jax_proposals
from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import vg_loader as jax_vg_loader
from imagecaptioning_tpu.eval import dense_eval as jax_eval
from imagecaptioning_tpu.models.densecap import DenseCapRPN as JaxRPN
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu_torch import train_DenseCap
from imagecaptioning_tpu_torch.config import dense_configs
from imagecaptioning_tpu_torch.data import proposals, synthetic, vg_loader
from imagecaptioning_tpu_torch.eval import dense_eval
from imagecaptioning_tpu_torch.models.densecap import DenseCapRPN
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.weights import (rpn_state_dict_from_jax,
                                                     rpn_train_state_from_jax,
                                                     seeded_init_)
import torch_threads  # noqa: F401  (one torch thread a test process)

KW = dict(num_pos=8, num_neg=8, test_proposals=20, embedding_size=16,
          rnn_size=16, vgg_stages=2, anchor_sizes=(8.0, 16.0, 32.0),
          anchor_ratios=(0.5, 1.0, 2.0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ optimizer

def _module_from(sd):
    """An nn.Module whose parameters carry the names (and values) of the
    state dict `sd`, for the optimizer, which sees nothing but names."""
    root = torch.nn.Module()
    for name, t in sd.items():
        *path, leaf = name.split(".")
        m = root
        for part in path:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, torch.nn.Parameter(t.clone()))
    return root


def _opt_case(finetune=True):
    """An RPN params tree of three VGG stages at narrow widths, six
    gradients, the port's counterpart and both configs."""
    cfg = jax_configs.get_densecap_config().replace(
        learning_rate=1e-3, weight_decay=1e-2, finetune_cnn=finetune)
    rng = np.random.RandomState(7)
    shapes = {"conv_trunk": {},
              "rpn_conv": {"kernel": (3, 3, 4, 6), "bias": (6,)},
              "rpn_scores": {"kernel": (1, 1, 6, 3), "bias": (3,)},
              "rpn_trans": {"kernel": (1, 1, 6, 12), "bias": (12,)},
              "recog_base": {"fc6": {"kernel": (7 * 7 * 4, 8), "bias": (8,)},
                             "fc7": {"kernel": (8, 8), "bias": (8,)}},
              "objectness": {"kernel": (8, 1), "bias": (1,)},
              "box_reg": {"kernel": (8, 4), "bias": (4,)},
              "llm": {"image_encoder": {"kernel": (8, 6), "bias": (6,)},
                      "lookup_table": {"embedding": (13, 6)},
                      "lstm": {"w_ih_l0": (24, 6), "w_hh_l0": (24, 6),
                               "b_ih_l0": (24,), "b_hh_l0": (24,)},
                      "linear": {"kernel": (6, 13), "bias": (13,)}}}
    cin = 3
    for stage, i in [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3)]:
        shapes["conv_trunk"][f"conv{stage}_{i}"] = {
            "kernel": (3, 3, cin, 4), "bias": (4,)}
        cin = 4

    def draw(scale):
        return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = draw(0.1)
    grads = [draw(0.1) for _ in range(6)]
    pm = _module_from(rpn_state_dict_from_jax(params))
    port_cfg = dense_configs.get_densecap_config().replace(
        learning_rate=1e-3, weight_decay=1e-2, finetune_cnn=finetune)
    return cfg, params, grads, pm, port_cfg


def _port_update(pm, opt, grads):
    g = rpn_state_dict_from_jax(grads)
    for name, p in pm.named_parameters():
        if p.requires_grad:
            p.grad = g[name].clone()
    opt.step()


def _assert_params(pm, params):
    want = rpn_state_dict_from_jax(params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("finetune", [True, False])
def test_rpn_optimizer_groups_match_optax(finetune):
    cfg, params, grads, pm, port_cfg = _opt_case(finetune)
    tx = jax_driver.make_dense_optimizer(cfg, 3)
    state = tx.init(params)
    opt = dense_driver.make_dense_optimizer(port_cfg, pm, 3)
    start = {n: p.detach().clone() for n, p in pm.named_parameters()}
    for k, g in enumerate(grads):
        upd, state = tx.update(g, state, params)
        params = _np(optax.apply_updates(params, upd))
        _port_update(pm, opt, g)
        _assert_params(pm, params)
        cur = dict(pm.named_parameters())
        for name in start:
            moved = not torch.equal(cur[name], start[name])
            idx = (int(name.split(".")[1]) if name.startswith("conv_trunk.")
                   else None)
            if idx is None:
                assert moved, name                       # the heads
            elif idx < 10 or not finetune:
                assert not moved, name                   # conv1/conv2
            else:
                assert moved == (k >= 3), (name, k)      # the encoder


def test_rpn_train_state_from_jax_resumes_like_optax():
    cfg, params, grads, pm, port_cfg = _opt_case()
    tx = jax_driver.make_dense_optimizer(cfg, 3)
    state = tx.init(params)
    for g in grads[:4]:                     # past the encoder's boundary
        upd, state = tx.update(g, state, params)
        params = _np(optax.apply_updates(params, upd))
    adam = {name: state.inner_states[name].inner_state[1]
            for name in ("encoder", "head")}
    adam = {k: (int(a.count), _np(a.mu), _np(a.nu)) for k, a in adam.items()}
    opt = dense_driver.make_dense_optimizer(port_cfg, pm, 3)
    sd, opt_sd = rpn_train_state_from_jax(params, adam, opt)
    pm.load_state_dict(sd)
    opt.load_state_dict(opt_sd)
    upd, state = tx.update(grads[4], state, params)
    params = _np(optax.apply_updates(params, upd))
    _port_update(pm, opt, grads[4])
    _assert_params(pm, params)


# ----------------------------------------------------------------- eval

def _records(seed):
    rng = np.random.RandomState(seed)
    words = "a man red car on the street tree dog sits".split()
    for _ in range(3):
        gt = np.stack([rng.uniform(20, 100, 5), rng.uniform(20, 100, 5),
                       rng.uniform(10, 60, 5), rng.uniform(10, 60, 5)], 1)
        gt[1] = gt[0] + 1.0                    # two GT merge at IoU ≥ 0.7
        det = np.concatenate([gt[:3] + rng.randn(3, 4),
                              np.stack([rng.uniform(20, 100, 4),
                                        rng.uniform(20, 100, 4),
                                        rng.uniform(10, 60, 4),
                                        rng.uniform(10, 60, 4)], 1)])
        scores = rng.randn(7)
        scores[5] = scores[2]                  # a tie: stable order
        caps = [" ".join(rng.choice(words, rng.randint(2, 6)))
                for _ in range(7)]
        refs = [" ".join(rng.choice(words, rng.randint(2, 6)))
                for _ in range(5)]
        yield scores, det, caps, gt, refs


def test_dense_evaluator_matches_jax():
    got, want = (dense_eval.DenseCaptioningEvaluator(),
                 jax_eval.DenseCaptioningEvaluator())
    for rec in _records(8):
        got.addResult(*rec)
        want.addResult(*rec)
    assert got.records == want.records and got.numAdded() == 3
    g, w = got.evaluate(), want.evaluate()
    for key in ("map", "ap_breakdown", "detmap", "det_breakdown", "meteor"):
        assert g[key] == w[key], key
    assert g["map"] > 0 and g["detmap"] > 0


@pytest.mark.parametrize("ns", [None, [1, 3, 7, 50]])
def test_eval_box_recalls_matches_jax(ns):
    for _, det, _, gt, _ in _records(9):
        assert dense_eval.eval_box_recalls(det, gt, ns) == \
            jax_eval.eval_box_recalls(det, gt, ns)


def _loaders(image_size=32):
    arrays, info = synthetic.make_vg_arrays(
        num_images=8, image_size=image_size, seq_length=8, seed=3)
    jarrays, jinfo = jax_synthetic.make_vg_arrays(
        num_images=8, image_size=image_size, seq_length=8, seed=3)
    return (vg_loader.VGDataLoader(arrays=arrays, info=info),
            jax_vg_loader.VGDataLoader(arrays=jarrays, info=jinfo))


@pytest.fixture(scope="module")
def eval_pair():
    """(jax model, params, port model, port loader, jax loader)."""
    loader, jloader = _loaders()
    kw = dict(KW, vocab_size=loader.getVocabSize(),
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
    pm.load_state_dict(rpn_state_dict_from_jax(params))
    return jm, params, pm, loader, jloader


def test_eval_split_rpn_matches_jax(eval_pair, monkeypatch):
    jm, params, pm, loader, jloader = eval_pair
    want = jax_driver.eval_split_rpn(jm, {"params": params}, jloader,
                                     split=0, max_regions=4,
                                     return_records=True)
    evaluators = []

    class Recording(dense_eval.DenseCaptioningEvaluator):
        def __init__(self):
            super().__init__()
            evaluators.append(self)
    monkeypatch.setattr(dense_eval, "DenseCaptioningEvaluator", Recording)
    got = dense_driver.eval_split_rpn(pm, loader, 0, 4)
    assert got["num_images"] == want["num_images"] == 6
    (evaluator,) = evaluators
    records = [{"candidate": r["candidate"], "references": r["references"]}
               for r in evaluator.records]
    assert records == want["records"] and records
    g, w = got["ap_results"], want["ap_results"]
    assert g["anchor_assignment"] == w["anchor_assignment"]
    assert g["proposal_recall"] == w["proposal_recall"]
    for key in ("map", "ap_breakdown", "detmap", "det_breakdown", "meteor"):
        assert g[key] == pytest.approx(w[key], abs=1e-9), key


def test_rpn_proposer_matches_jax(eval_pair):
    jm, params, pm, _, _ = eval_pair
    img = np.random.RandomState(2).randint(0, 256, (40, 30, 3), np.uint8)
    want = jax_proposals.rpn_proposer(jm, {"params": params}, pad_to=32)(img)
    got = proposals.rpn_proposer(pm, pad_to=32)(img)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert 0 < got.shape[0] <= KW["test_proposals"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_densecap_config_matches_jax():
    got = dense_configs.get_densecap_config().to_dict()
    want = jax_configs.get_densecap_config().to_dict()
    for key in ("backend", "device"):       # the card, not the TPU
        got.pop(key), want.pop(key)
    assert got == want and got["model_type"] == "rpn" and got["use_lstm"]


# --------------------------------------------------------------- driver

def test_rpn_train_step_draws_from_the_generator():
    loader, _ = _loaders()
    batch = next(loader.padded_batches(0, 2, 4))
    runs = []
    for _ in range(2):
        cfg = dense_configs.get_densecap_config().replace(
            compute_dtype="float32", vgg_stages=2)
        model = seeded_init_(DenseCapRPN(
            vocab_size=loader.getVocabSize(),
            seq_length=loader.getSeqLength(), **KW), 0)
        opt = dense_driver.make_dense_optimizer(cfg, model, 0)
        gen = torch.Generator().manual_seed(5)
        step = dense_driver.make_rpn_train_step(model, opt, gen)
        images, boxes, labels, mask = dense_driver.to_device(
            batch, torch.device("cpu"))
        trunk = model.conv_trunk[0].weight.detach().clone()
        losses = [step(images, boxes, mask, labels) for _ in range(2)]
        assert torch.equal(model.conv_trunk[0].weight, trunk)  # conv1 frozen
        assert model.rpn_trans.weight.grad.abs().sum() > 0
        runs.append((losses, gen.get_state()))
    (first, g1), (second, g2) = runs
    assert torch.equal(g1, g2)
    for a, b in zip(first, second):
        assert sorted(a) == ["box_decay", "captioning", "end_box_reg",
                             "end_objectness", "mid_box_reg",
                             "mid_objectness", "pos_occupancy", "total"]
        for k in a:
            assert torch.isfinite(a[k]) and torch.equal(a[k], b[k]), k
    assert float(first[1]["total"]) != float(first[0]["total"])


def _cli_args(tmp_path, **extra):
    kv = dict(data_h5=tmp_path / "missing.h5", data_json=tmp_path / "m.json",
              save_path=tmp_path / "models/best_densecap.ckpt",
              loss_file=tmp_path / "loss_logs/loss_densecap.json",
              result_file=tmp_path / "logs/results_densecap.json",
              batch_size=2, max_regions=4, compute_dtype="float32",
              vgg_stages=2, rnn_size=32, input_encoding_size=32,
              sampler_batch_size=16, test_num_proposals=20,
              losses_log_every=1, **extra)
    return [f"{k}={v}" for k, v in kv.items()]


def test_train_densecap_cli_trains_and_resumes(tmp_path):
    out = train_DenseCap.main(_cli_args(tmp_path, max_iters=2,
                                        save_checkpoint_every=2)
                              + ["--device", "cpu"])
    assert out["iters"] == 2 and isinstance(out["model"], DenseCapRPN)
    losses = out["final_losses"]
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["captioning"] > 0 and losses["total"] > 0
    save = str(tmp_path / "models/best_densecap.ckpt")
    assert ckptlib.restore_checkpoint(save)["step"] == 2
    results = json.loads(open(tmp_path / "logs/results_densecap.json").read())
    assert "anchor_assignment" in results[-1]["ap_results"]
    out = train_DenseCap.main(_cli_args(tmp_path, max_iters=3,
                                        save_checkpoint_every=3,
                                        from_checkpoint=True)
                              + ["--device", "cpu"])
    assert out["iters"] == 3
    records = json.loads(open(tmp_path / "loss_logs/loss_densecap.json")
                         .read())
    assert [r["iter"] for r in records] == [1, 2, 3]
    assert not os.path.exists(save + ".preempt")
    shutil.rmtree(tmp_path / "models")      # ~0.5 GB of fc6/fc7 and Adam


@pytest.mark.parametrize("knob", ["grad_accum_steps=2", "encoder_init=x.npz",
                                  "tensorboard_dir=tb"])
def test_train_densecap_refuses_unported_knobs(tmp_path, knob):
    """Each knob the CLI once refused runs two steps: 2 micro-steps make
    one update; a converted 2-stage `conv_trunk` file (conv1/conv2, which
    stay frozen) is the trunk after training; TensorBoard events are
    written."""
    key, value = knob.split("=")
    if key == "encoder_init":
        rng = np.random.RandomState(0)
        trunk, cin = {}, 3
        for name, cout in (("conv1_1", 64), ("conv1_2", 64),
                           ("conv2_1", 128), ("conv2_2", 128)):
            trunk[f"params/{name}/kernel"] = (
                rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
            trunk[f"params/{name}/bias"] = rng.randn(cout).astype(np.float32)
            cin = cout
        np.savez(tmp_path / value, **trunk)
        value = str(tmp_path / value)
    elif key == "tensorboard_dir":
        value = str(tmp_path / value)
    out = train_DenseCap.main(
        _cli_args(tmp_path, max_iters=2, save_checkpoint_every=2)
        + [f"{key}={value}", "--device", "cpu"])
    assert out["iters"] == 2
    assert all(np.isfinite(v) for v in out["final_losses"].values())
    opt = out["optimizer"]
    steps = {int(s["step"]) for s in opt.state.values()}
    assert steps == ({1} if key == "grad_accum_steps" else {2})
    if key == "encoder_init":
        want = trunk["params/conv2_2/kernel"].transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(
            out["model"].conv_trunk[7].weight.detach().numpy(), want)
    if key == "tensorboard_dir":
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    shutil.rmtree(tmp_path / "models")


def test_train_densecap_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_DenseCap.main(_cli_args(tmp_path, max_iters=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dense_driver.train_rpn(dense_configs.get_densecap_config())
