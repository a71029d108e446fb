"""The PyTorch port's AlexCap LSTM training path against the JAX package,
at a tiny size (ResNet stages (1, 1, 1, 1), head widths 16, batch 2),
fp32 on the CPU.

- `make_optimizer` (clip → {encoder, head} Adam with L2 before the
  moments) against optax over 6-8 updates spanning `finetune_start`, with
  a constant lr and with `use_scheduler` (warmup + cosine on global
  time): params within 1e-6; the encoder's Adam state absent before the
  boundary and counted from it; `captioner_train_state_from_jax`
  carrying a JAX state across the boundary, then the same updates within
  1e-6;
- two full train steps (uint8 → preprocess → forward → loss → backward →
  clip → Adam → BatchNorm statistics) against `make_train_step`, both
  sides in fp64 (a ReLU's input near zero, see the test): losses
  within 1e-5 relative, weights and running statistics within 1e-5, the
  gradient norm within 1e-4 relative (Adam's eps raised to 1e-3 there,
  see the test);
- synthetic Face2Text arrays byte-equal; `AlexDataLoader` batches
  identical in both modes (sequential and shuffled), through `get_batch`,
  after a resume cursor and from an HDF5 file; the device store's gather
  identical to the streaming batches and to JAX's;
- `eval_split` greedy and beam-3: records identical, METEOR, BLEU, BLEU-4
  and CIDEr within 1e-9; CIDEr-D and the scorer on edge cases;
- the config copy (the JAX fields but `backend` and `device`, the mesh
  fields included) and its artifact names equal to JAX's;
- `train` end to end: histories in the reference schema, the best
  checkpoint, a preemption checkpoint and a resume that continues the
  batch cursor and ends on the uninterrupted run's loss; the
  `train_LSTM --smoke` and `infer --model-type lstm` CLIs on the CPU;
  both raise without a card unless asked for the CPU; the driver's knobs
  (`grad_accum_steps`, `tensorboard_dir`, `debug_nans`, the learnable
  synthetic data) run together.
"""

import dataclasses
import json
import os
import signal
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from imagecaptioning_tpu.config import configs as jax_configs
from imagecaptioning_tpu.data import device_store as jax_store
from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import transforms as jax_transforms
from imagecaptioning_tpu.data.loader import AlexDataLoader as JaxLoader
from imagecaptioning_tpu.eval import cider as jax_cider
from imagecaptioning_tpu.eval import scorer as jax_scorer
from imagecaptioning_tpu.eval.eval_split import eval_split as jax_eval_split
from imagecaptioning_tpu.models.captioners import LSTMCaptioner as JaxLSTM
from imagecaptioning_tpu.train import optim as jax_optim
from imagecaptioning_tpu.train import step as jax_step
from imagecaptioning_tpu_torch import infer, train_LSTM
from imagecaptioning_tpu_torch.config import configs
from imagecaptioning_tpu_torch.data import device_store, synthetic
from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
from imagecaptioning_tpu_torch.eval import cider, scorer
from imagecaptioning_tpu_torch.eval.eval_split import eval_split
from imagecaptioning_tpu_torch.models.captioners import LSTMCaptioner
from imagecaptioning_tpu_torch.train import cli, driver, optim
from imagecaptioning_tpu_torch.train.step import make_train_step
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.weights import (
    captioner_train_state_from_jax, lstm_captioner_state_dict_from_jax)
import torch_threads  # noqa: F401  (one torch thread a test process)

STAGES = (1, 1, 1, 1)
WIDTHS = dict(embedding_size=16, lstm_size=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    """(the JAX LSTM config, the port's) with the same overrides."""
    return (jax_configs.get_lstm_config().replace(**kw),
            configs.get_lstm_config().replace(**kw))


# ------------------------------------------------ module 13: the config

def test_config_copy_and_names_match_jax():
    jc, pc = jax_configs.get_lstm_config(), configs.get_lstm_config()
    port_fields = {f.name for f in dataclasses.fields(pc)}
    jax_fields = {f.name for f in dataclasses.fields(jc)}
    assert port_fields < jax_fields
    assert jax_fields - port_fields == {"backend", "device"}
    assert {"mesh_shape", "mesh_axis_names"} < port_fields
    for name in port_fields:
        assert getattr(pc, name) == getattr(jc, name), name
    for kw in ({}, {"iterate": True, "use_dropout": True, "batch_size": 4},
               {"use_vggface": True, "clip_grad": False}):
        assert configs.name_model(pc.replace(**kw)) == \
            jax_configs.name_model(jc.replace(**kw))
    over = {"backbone_stages": "1,2,1,1", "use_beam": "true", "seed": "3",
            "learning_rate": "0.5"}
    got = configs.apply_overrides(pc, over).to_dict()
    want = jax_configs.apply_overrides(jc, over).to_dict()
    for name in port_fields:
        assert got[name] == want[name], name
    for left_out in ("backend", "device"):
        with pytest.raises(KeyError, match="--device"):
            configs.apply_overrides(pc, {left_out: "cpu"})
    mesh = {"mesh_shape": "-1,2", "mesh_axis_names": "data,model"}
    assert configs.apply_overrides(pc, mesh).mesh_shape == (-1, 2)


# -------------------------------------------------- module 7: optimizer

class _Toy(nn.Module):
    """A `features` (encoder) and an `llm` (head) parameter group."""

    def __init__(self, params):
        super().__init__()
        for top, leaves in params.items():
            self.add_module(top, nn.ParameterDict({
                k: nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in leaves.items()}))


def _toy_case(steps, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"features": {"w": (6, 5), "b": (5,)},
              "llm": {"w": (7, 3), "b": (3,)}}
    params = {t: {k: (rng.randn(*s) * 0.1).astype(np.float32)
                  for k, s in leaves.items()} for t, leaves in shapes.items()}
    grads = [{t: {k: (rng.randn(*s) * 0.8).astype(np.float32)
                  for k, s in leaves.items()}
              for t, leaves in shapes.items()} for _ in range(steps)]
    return params, grads


def _port_step(model, opt, g, frozen, clip=1.0):
    for top, leaves in g.items():
        for k, v in leaves.items():
            p = getattr(model, top)[k]
            p.grad = (None if frozen and top == "features"
                      else torch.from_numpy(v.copy()))
    params = list(model.parameters())
    norm = optim.global_norm(params)
    optim.clip_by_global_norm_(params, clip, norm)
    opt.step()
    return float(norm)


@pytest.mark.parametrize("scheduler", [False, True],
                         ids=["constant", "use_scheduler"])
def test_optimizer_matches_optax_across_finetune_start(scheduler):
    steps, total, boundary = (8, 12, 3) if scheduler else (6, 6, 3)
    jc, pc = _cfgs(use_scheduler=scheduler, num_epochs=4,
                   learning_rate=3e-3, min_lr=1e-4)
    params, grads = _toy_case(steps)
    tx = jax_optim.make_optimizer(jc, total, boundary)
    state = tx.init(params)
    model = _Toy(params)
    opt = optim.make_optimizer(pc, model, total)
    assert [g["group"] for g in opt.param_groups] == ["head", "encoder"]
    for k, g in enumerate(grads):
        frozen = k < boundary
        jg = jax.tree.map(np.copy, g)
        if frozen:              # the frozen model's encoder gradient
            jg["features"] = jax.tree.map(np.zeros_like, jg["features"])
        jnorm = float(optax.global_norm(jg))
        assert jnorm > 1.0                          # the clip acts
        upd, state = tx.update(jg, state, params)
        params = _np(optax.apply_updates(params, upd))
        norm = _port_step(model, opt, g, frozen)
        assert norm == pytest.approx(jnorm, rel=1e-6)
        for top, leaves in params.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    getattr(model, top)[name].detach().numpy(), want,
                    rtol=0, atol=1e-6, err_msg=f"{top}.{name} step {k}")
        enc = opt.state.get(model.features["w"], {})
        assert ("step" in enc) == (not frozen)
        if not frozen:
            assert int(enc["step"]) == k - boundary + 1
    if scheduler:
        sched = jax_optim.warmup_cosine(jc.learning_rate, jc.min_lr,
                                        max(2 * total // 4, 1), total)
        port = optim.warmup_cosine(pc.learning_rate, pc.min_lr,
                                   max(2 * total // 4, 1), total)
        for k in range(total + 2):
            assert port(k) == pytest.approx(float(sched(k)), rel=1e-6,
                                            abs=1e-12)


def test_optimizer_without_finetune_leaves_the_trunk_alone():
    _, pc = _cfgs(finetune_cnn=False)
    params, grads = _toy_case(2)
    model = _Toy(params)
    opt = optim.make_optimizer(pc, model, 4)
    assert [g["group"] for g in opt.param_groups] == ["head"]
    _port_step(model, opt, grads[0], frozen=False)
    np.testing.assert_array_equal(model.features["w"].detach().numpy(),
                                  params["features"]["w"])
    # the Transformer's trunk is a hard zero whatever finetune_cnn says
    opt = optim.make_optimizer(pc.replace(model_type="transformer",
                                          finetune_cnn=True), model, 4)
    assert isinstance(opt, optim.AlexAdamW)
    assert [g["group"] for g in opt.param_groups] == ["head"]
    # accumulating, the trunk outside every group still has its gradient
    # averaged (for the clip) and stays put
    opt = optim.make_optimizer(pc.replace(grad_accum_steps=2), model, 4)
    assert opt.every == 2 and [g["group"] for g in opt.param_groups] == [
        "head"]
    assert "features.w" in opt.accumulated
    for k, g in enumerate(_toy_case(2, seed=1)[1]):
        for top, leaves in g.items():
            for name, v in leaves.items():
                getattr(model, top)[name].grad = torch.from_numpy(v.copy())
        assert opt.accumulate() == (k == 1)
    assert opt.state_dict()["accumulation"]["mini_step"] == 0
    opt.step()
    np.testing.assert_array_equal(model.features["w"].detach().numpy(),
                                  params["features"]["w"])


def _tiny_jax_state(x, gt, **kw):
    model = JaxLSTM(vocab_size=20, embedding_size=16, rnn_size=16,
                    backbone_stages=STAGES, **kw)
    k = jax.random.PRNGKey(0)
    v = jax.jit(partial(model.init, train=False))(
        {"params": k, "dropout": k}, jnp.asarray(x), jnp.asarray(gt))
    return model, _np(v["params"]), _np(v["batch_stats"])


def test_train_state_from_jax_carries_the_gate_across_the_boundary():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    gt = rng.randint(1, 21, (1, 4)).astype(np.int32)
    _, params, stats = _tiny_jax_state(x, gt)
    jc, pc = _cfgs(learning_rate=1e-3, **WIDTHS)
    tx = jax_optim.make_optimizer(jc, 10, 3)
    state = tx.init(params)
    update = jax.jit(tx.update)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.05).astype(
        np.float32), params) for _ in range(5)]

    def frozen(g, k):
        return ({**g, "features": jax.tree.map(np.zeros_like, g["features"])}
                if k < 3 else g)
    for k in range(2):                               # before the boundary
        upd, state = update(frozen(grads[k], k), state, params)
        params = _np(optax.apply_updates(params, upd))
    model = LSTMCaptioner(20, 16, 16, backbone_stages=STAGES)
    opt = optim.make_optimizer(pc, model, 10)
    sd, opt_sd = captioner_train_state_from_jax(params, stats, state, opt)
    model.load_state_dict(sd)
    opt.load_state_dict(opt_sd)
    assert not any(p in opt.state for p in model.features.parameters())
    for k in range(2, 5):                            # across it
        upd, state = update(frozen(grads[k], k), state, params)
        params = _np(optax.apply_updates(params, upd))
        g = lstm_captioner_state_dict_from_jax(grads[k], stats)
        for name, p in model.named_parameters():
            p.grad = (None if k < 3 and name.startswith("features.")
                      else g[name].clone())
        ps = list(model.parameters())
        optim.clip_by_global_norm_(ps, 1.0, optim.global_norm(ps))
        opt.step()
    want = lstm_captioner_state_dict_from_jax(params, stats)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


# -------------------------------------------------- module 8: train step

def test_two_train_steps_match_jax():
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (2, 2, 218, 178, 3), dtype=np.uint8)
    gts = rng.randint(1, 21, (2, 2, 5)).astype(np.int32)
    gts[0, 1, 2:] = 0
    jm, params, stats = _tiny_jax_state(
        np.zeros((2, 224, 224, 3), np.float32), gts[0])
    # Adam's first update is lr·g/(|g| + eps): with the default eps a
    # gradient element within rounding of zero moves its weight by up to
    # 2·lr apart in the two frameworks; eps 1e-3 keeps the update
    # continuous in the gradient, so the weights compare at 1e-5
    jc, pc = _cfgs(learning_rate=1e-4, eps=1e-3, **WIDTHS)
    # Both sides preprocess and compute in fp64. The input of one ReLU at
    # the trunk's top lies within 4e-5 of zero for the first batch,
    # inside fp32's rounding of it (which moves with torch's CPU thread
    # count and with the preprocessing's dtype); where its side flips,
    # BatchNorm's backward spreads that one gradient element over the
    # whole trunk: 1.2 % of every trunk gradient, 8e-5 of the norm.
    with jax.enable_x64(True):
        jm = jm.clone(compute_dtype=jnp.float64)
        params, stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     (params, stats))
        tx = jax_optim.make_optimizer(jc, 10, 0)
        state = jax_step.TrainState(jnp.array(0, jnp.int32), params,
                                    tx.init(params), stats,
                                    jax.random.PRNGKey(1))
        jstep = jax.jit(jax_step.make_train_step(
            jm, tx, preprocess=partial(jax_transforms.resnet_v2_preprocess,
                                       dtype=jnp.float64)))

        model = LSTMCaptioner(20, 16, 16, backbone_stages=STAGES,
                              compute_dtype=torch.float64).double()
        model.load_state_dict(lstm_captioner_state_dict_from_jax(
            _np(params), _np(stats)))
        opt = optim.make_optimizer(pc, model, 10)
        step = make_train_step(model, opt, torch.Generator().manual_seed(0),
                               partial(resnet_v2_preprocess,
                                       dtype=torch.float64), clip_norm=1.0)
        # the gradient norm within 1e-4: at the second step it is taken at
        # weights already ~6e-8 apart (JAX's head computes in fp32)
        for k in range(2):
            state, metrics = jstep(state, jnp.asarray(images[k]),
                                   jnp.asarray(gts[k]))
            got = step(torch.from_numpy(images[k]),
                       torch.from_numpy(gts[k]))
            assert float(got["loss"]) == pytest.approx(
                float(metrics["loss"]), rel=1e-5), k
            assert float(got["grad_norm"]) == pytest.approx(
                float(metrics["grad_norm"]), rel=1e-4), k
        want = lstm_captioner_state_dict_from_jax(_np(state.params),
                                                  _np(state.batch_stats))
    got_sd = model.state_dict()
    for name, t in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got_sd[name]) == 2
            continue
        np.testing.assert_allclose(got_sd[name].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------- modules 9-11: the data

def test_synthetic_face2text_arrays_match_jax():
    got, got_info = synthetic.make_face2text_arrays(num_images=12, seed=5)
    want, want_info = jax_synthetic.make_face2text_arrays(num_images=12,
                                                          seed=5)
    assert sorted(got) == sorted(want) and got_info == want_info
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _loaders(num_images=20, seed=7):
    arrays, info = jax_synthetic.make_face2text_arrays(num_images=num_images,
                                                       seed=2)
    return (AlexDataLoader(arrays=arrays, info=info, seed=seed),
            JaxLoader(arrays=arrays, info=info, seed=seed), arrays, info)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,start", [(False, 0), (False, 5),
                                           (True, 0)])
def test_loader_batches_match_jax(shuffle, start):
    port, jaxl, _, _ = _loaders()
    for _ in range(2):                       # two epochs: the RNG advances
        _same_batches(port.epoch_batches(0, 3, shuffle=shuffle, start=start),
                      jaxl.epoch_batches(0, 3, shuffle=shuffle, start=start))
    for split in (0, 1):
        _same_batches([port.resident_arrays(split)],
                      [jaxl.resident_arrays(split)])


@pytest.mark.parametrize("iterate", [True, False])
def test_get_batch_and_resume_cursor_match_jax(iterate):
    port, jaxl, _, _ = _loaders()
    opt = {"split": 0, "iterate": iterate}
    for _ in range(7):
        got, want = port.get_batch(opt, 4), jaxl.get_batch(opt, 4)
        for g, w in zip((got[0], got[1], got[3]), (want[0], want[1],
                                                   want[3])):
            np.testing.assert_array_equal(g, w)
        assert got[2][0]["filename"] == want[2][0]["filename"]
        np.testing.assert_array_equal(got[2][0]["split_bounds"][0],
                                      want[2][0]["split_bounds"][0])
        assert port.iterators == jaxl.iterators
    resumed, _, _, _ = _loaders()
    resumed.iterators = dict(port.iterators)         # the checkpoint's
    if iterate:
        np.testing.assert_array_equal(resumed.get_batch(opt, 4)[1],
                                      port.get_batch(opt, 4)[1])


def test_hdf5_loader_matches_arrays(tmp_path):
    import h5py
    _, _, arrays, info = _loaders()
    h5, js = tmp_path / "f2t.h5", tmp_path / "f2t.json"
    with h5py.File(h5, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    js.write_text(json.dumps(info))
    for cache in (True, False):
        loaded = AlexDataLoader(data_h5=str(h5), data_json=str(js),
                                cache_images=cache, seed=7)
        _same_batches(loaded.epoch_batches(0, 3, shuffle=True),
                      _loaders()[0].epoch_batches(0, 3, shuffle=True))


def test_device_store_gather_matches_streaming_and_jax():
    port, jaxl, _, _ = _loaders()
    store = device_store.stage_split(port, 0, torch.device("cpu"))
    jstore = jax_store.stage_split(jaxl, 0)
    assert store.num_items == len(port.split_ix[0])
    stream = driver._batch_iterator(_loaders()[0],
                                    configs.get_lstm_config(), 3)
    feed = device_store.index_stream(port, 0, 3, iterate=False)
    jfeed = jax_store.index_stream(jaxl, 0, 3, iterate=False)
    for _ in range(8):                       # past an epoch's end
        pos = next(feed)
        np.testing.assert_array_equal(pos, next(jfeed))
        images, labels = device_store.gather_batch(store,
                                                   torch.from_numpy(pos))
        want_images, want_labels = jax_store.gather_batch(
            jstore, jnp.asarray(pos))
        s_images, s_labels = next(stream)
        np.testing.assert_array_equal(images.numpy(), want_images)
        np.testing.assert_array_equal(images.numpy(), s_images)
        np.testing.assert_array_equal(labels.numpy(), want_labels)
        np.testing.assert_array_equal(labels.numpy(), s_labels)
    assert device_store.fits(10, None)
    assert device_store.fits(35, 100) and not device_store.fits(36, 100)


# ---------------------------------------------------- module 12: eval

def test_scorer_and_cider_match_jax():
    records = [
        {"candidate": "a man with a beard", "references": [
            "a man with a beard", "an old man with a gray beard"]},
        {"candidate": "", "references": ["a woman smiling"]},
        {"candidate": "woman smiling with hair", "references": [
            "a young woman with long hair smiling"]},
        {"candidate": "the the the", "references": [""]},
    ]
    got, want = scorer.score_captions(records), \
        jax_scorer.score_captions(records)
    for key in ("meteor", "bleu", "bleu4", "cider"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    c, jc = cider.CiderD(), jax_cider.CiderD()
    for r in records[:3]:
        c.add(r["candidate"].split(), [x.split() for x in r["references"]])
        jc.add(r["candidate"].split(), [x.split() for x in r["references"]])
    assert c.compute() == jc.compute()


@pytest.mark.parametrize("use_beam", [False, True], ids=["greedy", "beam3"])
def test_eval_split_matches_jax(use_beam):
    port_loader, jax_loader, _, _ = _loaders(num_images=20)
    vocab, seq = port_loader.getVocabSize(), port_loader.getSeqLength()
    jm = JaxLSTM(vocab_size=vocab, embedding_size=16, rnn_size=16,
                 backbone_stages=STAGES)
    k = jax.random.PRNGKey(0)
    v = jax.jit(partial(jm.init, train=False))(
        {"params": k, "dropout": k}, jnp.zeros((1, 224, 224, 3)),
        jnp.ones((1, seq), jnp.int32))
    params, stats = _np(v["params"]), _np(v["batch_stats"])
    model = LSTMCaptioner(vocab, 16, 16, backbone_stages=STAGES)
    model.load_state_dict(lstm_captioner_state_dict_from_jax(params, stats))
    want = jax_eval_split(jm, {"params": params, "batch_stats": stats},
                          jax_loader, split=0, batch_size=4,
                          preprocess=jax_transforms.resnet_v2_preprocess,
                          use_beam=use_beam, beam_size=3, max_images=8,
                          return_records=True)
    got = eval_split(model, port_loader, split=0, batch_size=4,
                     preprocess=resnet_v2_preprocess, use_beam=use_beam,
                     beam_size=3, max_images=8, return_records=True)
    assert got["num_images"] == want["num_images"] == 8
    assert got["records"] == want["records"]
    assert any(r["candidate"] for r in got["records"])
    for key in ("meteor", "bleu", "bleu4", "cider"):
        assert got["ap_results"][key] == pytest.approx(
            want["ap_results"][key], abs=1e-9), key


# ------------------------------------------- modules 14-15: the driver

def _cfg(tmp_path, **kw):
    base = dict(data_h5="/nonexistent", save_checkpoint_every=4,
                batch_size=2, eval_val_batch_size=2, num_epochs=1,
                backbone_stages=STAGES, compute_dtype="float32",
                save_path=str(tmp_path / "models/best_model_LSTM.ckpt"),
                loss_file=str(tmp_path / "loss_logs/loss_history_LSTM.json"),
                result_file=str(tmp_path / "logs/results_history_LSTM.json"),
                **WIDTHS)
    return configs.get_lstm_config().replace(**{**base, **kw})


_MAKE_TRAIN_STEP = driver.make_train_step


def _record_steps(monkeypatch, seen, kill_at=None):
    """Record each train step's batch (its images' sum); SIGTERM during
    step `kill_at`."""
    def make(*a, **k):
        step = _MAKE_TRAIN_STEP(*a, **k)

        def wrapped(images, gt):
            seen.append(int(images.long().sum()))
            if kill_at is not None and len(seen) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(images, gt)
        return wrapped
    monkeypatch.setattr(driver, "make_train_step", make)


@pytest.mark.parametrize("resident", ["on", "off"])
def test_train_histories_checkpoint_and_resume(tmp_path, monkeypatch,
                                               resident):
    # frozen trunk throughout (finetune boundary after 100 epochs): the
    # checkpoints carry no trunk moments
    kw = dict(iterate=True, finetuning_after_nepoch=100,
              device_resident_data=resident)
    full = []
    _record_steps(monkeypatch, full)
    ref = driver.train(_cfg(tmp_path / "ref", **kw), device="cpu",
                       max_iter_override=6, eval_every_override=3,
                       synthetic_images=20, verbose=False)
    cfg = _cfg(tmp_path / "run", **kw)
    loss_file, result_file, save_path = configs.name_model(cfg)
    assert (loss_file, result_file, save_path) == jax_configs.name_model(
        jax_configs.get_lstm_config().replace(
            **{k: getattr(cfg, k) for k in ("save_path", "loss_file",
                                            "result_file", "batch_size",
                                            "iterate")}))
    seen = []
    _record_steps(monkeypatch, seen, kill_at=4)
    out = driver.train(cfg, device="cpu", max_iter_override=6,
                       eval_every_override=3, synthetic_images=20,
                       verbose=False)
    assert out["iters"] == 4 and os.path.isfile(save_path + ".preempt")
    assert os.path.isfile(save_path)                 # best at iter 3
    best = ckptlib.restore_checkpoint(save_path)
    assert best["step"] == 3 and set(best) == {
        "model", "optimizer", "step", "generator", "iterators"}
    assert ckptlib.resume_path(save_path) == save_path + ".preempt"
    losses = json.loads(open(loss_file).read())
    assert [sorted(r) for r in losses] == [["epoch time in ms", "iter",
                                            "loss"]] * 4
    results = json.loads(open(result_file).read())
    assert sorted(results[0]) == ["ap_results", "best_iter",
                                  "best_val_score", "iter", "loss_results",
                                  "num_images"]
    assert {"meteor", "bleu", "bleu4", "cider"} <= set(
        results[0]["ap_results"])
    _record_steps(monkeypatch, seen)
    out = driver.train(cfg.replace(from_checkpoint=True), device="cpu",
                       max_iter_override=6, eval_every_override=3,
                       synthetic_images=20, verbose=False)
    assert out["iters"] == 6 and seen == full
    assert out["final_loss"] == ref["final_loss"]
    assert [r["iter"] for r in json.loads(open(loss_file).read())] == [
        1, 2, 3, 4, 5, 6]
    assert "greedy" in out["final_test"]


def test_log_every_sets_the_loss_log_stride(tmp_path):
    # pad = save_checkpoint_every // bs² = 1 here; log_every=2 overrides it
    cfg = _cfg(tmp_path, log_every=2, finetuning_after_nepoch=100)
    driver.train(cfg, device="cpu", max_iter_override=4,
                 eval_every_override=4, synthetic_images=8, verbose=False)
    loss_file = configs.name_model(cfg)[0]
    assert [r["iter"] for r in json.loads(open(loss_file).read())] == [2, 4]


def test_unported_knobs_raise(tmp_path, monkeypatch):
    """The driver's remaining knobs run, all at once: 4 micro-steps at
    grad_accum_steps 2 (2 applied updates), TensorBoard events, anomaly
    mode (on during the loop only) and the learnable synthetic captions;
    a missing encoder_init file is a file error."""
    monkeypatch.setattr(ckptlib, "save_checkpoint", lambda path, state: None)
    cfg = _cfg(tmp_path, grad_accum_steps=2, debug_nans=True,
               tensorboard_dir=str(tmp_path / "tb"))
    out = driver.train(cfg, device="cpu", max_iter_override=4,
                       eval_every_override=4, synthetic_images=12,
                       synthetic_learnable=True, verbose=False)
    assert out["iters"] == 4 and np.isfinite(out["final_loss"])
    assert out["optimizer"].param_groups[0]["updates"] == 2
    assert not torch.is_anomaly_enabled()
    assert {"hair", "shirt"} <= set(out["loader"].vocab.token_to_idx)
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    loss_file = configs.name_model(cfg)[0]
    assert [r["iter"] for r in json.loads(open(loss_file).read())] == [
        1, 2, 3, 4]
    with pytest.raises(FileNotFoundError):
        driver.train(cfg.replace(encoder_init=str(tmp_path / "w.npz")),
                     device="cpu")


def test_train_lstm_smoke_and_infer_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    summary = cli.main("lstm", [
        "--smoke", "--device", "cpu", "--set", "backbone_stages=1,1,1,1",
        "embedding_size=16", "lstm_size=16", "compute_dtype=float32",
        "use_beam=true"])
    assert summary["iters"] == 8 and np.isfinite(summary["final_loss"])
    # the final test eval: greedy, then the reference drivers' beam sweep
    assert sorted(summary["final_test"]) == [
        "beam_1", "beam_2", "beam_3", "beam_4", "beam_5", "greedy"]
    assert os.path.isfile(summary["loss_file"])
    assert os.path.isfile(summary["result_file"])
    assert os.path.isfile(summary["save_path"])
    assert summary["final_test"]["greedy"]["num_images"] > 0
    arrays, info = synthetic.make_face2text_arrays(num_images=32, seed=123)
    (tmp_path / "dicts.json").write_text(json.dumps(info))
    from PIL import Image
    (tmp_path / "photos").mkdir()
    for i in range(2):
        Image.fromarray(arrays["images"][i]).save(tmp_path / f"photos/{i}.png")
    args = ["--model-type", "lstm", "--ckpt", summary["save_path"],
            "--dicts", "dicts.json", "--images", "photos", "--device",
            "cpu", "--set", "backbone_stages=1,1,1,1", "embedding_size=16",
            "lstm_size=16"]
    greedy = infer.main(args)
    beam = infer.main(args + ["--beam", "3"])
    assert sorted(greedy) == sorted(beam) == ["0.png", "1.png"]
    assert all(isinstance(c, str) for c in greedy.values())


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_LSTM.main("lstm", ["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--model-type", "lstm", "--ckpt", "x", "--dicts", "y",
                    "--images", str(tmp_path)])
