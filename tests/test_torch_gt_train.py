"""The PyTorch port's GT-box dense-caption training path against the JAX
package, at a tiny size (2–3 VGG stages, widths ≤ 32), fp32.

Same numpy inputs and the same (converted) weights on both sides:
- `decoder_target` equal; `temporal_cross_entropy` within 1e-6 relative
  (one fp32 reduction in another order);
- the GT loss within 1e-5 and every parameter's gradient within 1e-4
  relative (max |got − want| ≤ 1e-4 · max |want| per tensor: the convs,
  the 4096-wide classifier and the ROI backward sum in another order);
- scheduled sampling at teacher_prob 0 and 1 (both Bernoulli streams are
  then fixed): logits within 1e-4;
- `make_dense_optimizer` against optax over 6 updates of fixed gradients
  (weight decay on, encoder from update 3 on, with and without per-group
  clipping), and `gt_train_state_from_jax` then one more update: params
  within 1e-6 (Adam's update is rounded in another order);
- synthetic arrays and loader batches byte-equal, resume cursor included.
Also: the classifier's dropout rate, bf16 compute over fp32 master
weights giving serving's bf16 numbers, checkpoints (round trip and resume
order), `train_gt` and its CLI end to end with either head (the
transformer's tests against JAX are in `test_torch_gt_transformer.py`),
the raise without CUDA, gradient accumulation in `make_dense_optimizer`
(its optax parity is in `test_torch_grad_accum.py`), and `encoder_init`
of `features` and `classifier` from JAX's own init: logits within 1e-4.
"""

import json
import os
import shutil
import signal
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecaptioning_tpu.config.dense_configs import \
    get_gt_config as jax_gt_config
from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import tokenizer as jax_tokenizer
from imagecaptioning_tpu.data import vg_loader as jax_vg_loader
from imagecaptioning_tpu.models.densecap import GTDenseCaptioner as JaxGT
from imagecaptioning_tpu.ops import losses as jax_losses
from imagecaptioning_tpu.ops import tokens as jax_tokens
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu_torch import traingt
from imagecaptioning_tpu_torch.config.dense_configs import (get_gt_config,
                                                            name_gt_model)
from imagecaptioning_tpu_torch.data import synthetic, vg_loader
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.models.backbones.vgg import VGGClassifierHead
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.ops import losses, tokens
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.weights import (gt_state_dict_from_jax,
                                                     gt_train_state_from_jax,
                                                     seeded_init_)
import torch_threads  # noqa: F401  (one torch thread a test process)

KW = dict(vocab_size=24, seq_length=5, embedding_size=16, rnn_size=16,
          vgg_stages=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed=0, n=2, r=4, size=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, size, size, 3).astype(np.float32)
    boxes = np.stack([rng.uniform(4, size - 4, (n, r)),
                      rng.uniform(4, size - 4, (n, r)),
                      rng.uniform(4, size - 8, (n, r)),
                      rng.uniform(4, size - 8, (n, r))],
                     axis=-1).astype(np.float32)
    boxes[0, 0] = [(size + 1) / 2, (size + 1) / 2, size, size]   # full image
    boxes[1, 1] = [1.0, 1.0, 1.0, 1.0]                          # pad box
    labels = rng.randint(1, KW["vocab_size"] + 1, (n, r, KW["seq_length"]))
    labels[0, 2, 3:] = 0                                   # a short caption
    mask = np.ones((n, r), np.float32)
    mask[1, 1] = 0.0                                       # a padded region
    return x, boxes, labels.astype(np.int32), mask


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model (fp32), inputs)."""
    x, boxes, labels, mask = _inputs()
    jm = JaxGT(use_lstm=True, **KW)
    k = jax.random.PRNGKey(0)
    v = jax.jit(partial(jm.init, train=False))(
        {"params": k, "sampling": k}, jnp.asarray(x), jnp.asarray(boxes),
        jnp.asarray(labels))
    params = _np(v["params"])
    pm = GTDenseCaptioner(**KW)
    pm.load_state_dict(gt_state_dict_from_jax(params))
    return jm, params, pm, (x, boxes, labels, mask)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------- tokens and loss

@pytest.mark.parametrize("scan_from", [0, 1])
def test_decoder_target_matches_jax(scan_from):
    rng = np.random.RandomState(scan_from)
    gt = rng.randint(1, 9, (6, 5)).astype(np.int32)
    gt[1, 2:] = 0
    gt[2, :] = 0
    gt[3, 1:] = 0
    want = np.asarray(jax_tokens.decoder_target(jnp.asarray(gt), 11,
                                                scan_from))
    got = tokens.decoder_target(torch.from_numpy(gt), 11, scan_from)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tokens.sequence_mask(got).numpy(),
        np.asarray(jax_tokens.sequence_mask(jnp.asarray(want))))


def test_temporal_cross_entropy_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 6, 13).astype(np.float32) * 3
    targets = rng.randint(0, 13, (5, 6)).astype(np.int32)
    targets[0] = 0
    want = float(jax_losses.temporal_cross_entropy(jnp.asarray(logits),
                                                   jnp.asarray(targets)))
    got = losses.temporal_cross_entropy(*_t(logits, targets))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    assert float(losses.temporal_cross_entropy(
        torch.zeros(2, 3, 4), torch.zeros(2, 3, dtype=torch.long))) == 0.0


# ------------------------------------------------- the model in training

def test_gt_loss_and_every_gradient_match_jax(pair):
    jm, params, pm, (x, boxes, labels, mask) = pair

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(boxes),
                       jnp.asarray(labels), train=False)
        return jm.loss(out, jnp.asarray(labels), jnp.asarray(mask))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    want = gt_state_dict_from_jax(_np(want_grads))

    pm.zero_grad(set_to_none=True)
    tx, tb, tl, tm = _t(x, boxes, labels, mask)
    out = pm(tx, tb, tl.long())
    loss = pm.loss(out, tl.long(), tm)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    names = [n for n, _ in pm.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in pm.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("teacher_prob", [0.0, 1.0])
def test_scheduled_sampling_matches_jax(pair, teacher_prob):
    jm, params, pm, (x, boxes, labels, _) = pair
    n, r, t = labels.shape
    rng = np.random.RandomState(4)
    codes = rng.randn(n * r, 1, 4096).astype(np.float32)
    dec_in = np.concatenate([np.full((n * r, 1), KW["vocab_size"] + 1),
                             labels.reshape(n * r, t)], 1).astype(np.int32)
    want = jm.apply({"params": params}, jnp.asarray(codes),
                    jnp.asarray(dec_in), jnp.float32(teacher_prob),
                    method=jm._scheduled_sampling,
                    rngs={"sampling": jax.random.PRNGKey(5)})
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        got = pm._scheduled_sampling(torch.from_numpy(codes),
                                     torch.from_numpy(dec_in).long(),
                                     teacher_prob, gen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # through forward(train=True): teacher_prob 1 is teacher forcing
    if teacher_prob == 1.0:
        with torch.no_grad():
            tx, tb, tl = _t(x, boxes, labels)
            codes_t = pm.encode_regions(tx, tb)
            forced = pm.llm(codes_t.reshape(n * r, 1, -1),
                            tokens.decoder_input(tl.long().reshape(n * r, t),
                                                 pm.spec.start))
            sampled = pm._scheduled_sampling(
                codes_t.reshape(n * r, 1, -1),
                tokens.decoder_input(tl.long().reshape(n * r, t),
                                     pm.spec.start), 1.0, gen)
        torch.testing.assert_close(sampled, forced, rtol=1e-5, atol=1e-5)


def test_classifier_dropout_rate():
    head = VGGClassifierHead(in_features=64)
    with torch.no_grad():
        head[3].weight.copy_(torch.eye(4096))
        head[3].bias.zero_()
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 64)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ev = head(x)
        tr = head(x, train=True, generator=gen)
        again = head(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(head(x), ev)                    # eval drops nothing
    assert torch.equal(tr, again)                      # the generator's draw
    live = ev > 0
    kept = (tr[live] > 0).float().mean()
    assert 0.45 < float(kept) < 0.55
    torch.testing.assert_close(tr[live & (tr > 0)], 2 * ev[live & (tr > 0)])


def test_bf16_compute_over_fp32_master_weights():
    """Training's fp32 master weights compute the bf16 numbers serving's
    bf16-stored weights do, and their gradients arrive in fp32."""
    x, boxes, labels, mask = _t(*_inputs(1))
    master = seeded_init_(GTDenseCaptioner(
        **KW, compute_dtype=torch.bfloat16, param_dtype=torch.float32), 3)
    serving = GTDenseCaptioner(**KW, compute_dtype=torch.bfloat16)
    serving.load_state_dict(master.state_dict())
    assert serving.features[0].weight.dtype == torch.bfloat16
    assert master.features[0].weight.dtype == torch.float32
    codes = master.encode_regions(x, boxes)
    with torch.no_grad():
        assert torch.equal(codes, serving.encode_regions(x, boxes))
    master.loss(master(x, boxes, labels.long()), labels.long(),
                mask).backward()
    for p in master.parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()


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


def _opt_case(clip, finetune=True):
    """A GT params tree of three VGG stages at narrow widths (the
    optimizer sees names, not shapes), six gradients, the port's
    counterpart and both configs."""
    cfg = jax_gt_config().replace(
        use_lstm=True, learning_rate=1e-3, weight_decay=1e-2,
        grad_clip_norm=clip, finetune_cnn=finetune)
    rng = np.random.RandomState(7)
    shapes = {"classifier": {"fc6": {"kernel": (7 * 7 * 4, 8),
                                     "bias": (8,)},
                             "fc7": {"kernel": (8, 8), "bias": (8,)}},
              "llm": {"image_encoder": {"kernel": (8, 6), "bias": (6,)},
                      "lookup_table": {"embedding": (13, 6)},
                      "lstm": {"w_ih_l0": (24, 6), "w_hh_l0": (24, 6),
                               "b_ih_l0": (24,), "b_hh_l0": (24,)},
                      "linear": {"kernel": (6, 13), "bias": (13,)}},
              "features": {}}
    cin = 3
    for stage, i in [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3)]:
        shapes["features"][f"conv{stage}_{i}"] = {"kernel": (3, 3, cin, 4),
                                                  "bias": (4,)}
        cin = 4

    def draw(scale):
        return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = draw(0.1)
    grads = [draw(0.1) for _ in range(6)]
    pm = _module_from(gt_state_dict_from_jax(params))
    port_cfg = get_gt_config().replace(**{
        k: getattr(cfg, k) for k in ("learning_rate", "weight_decay",
                                     "grad_clip_norm", "finetune_cnn")})
    return cfg, params, grads, pm, port_cfg


def _port_update(pm, opt, grads):
    g = gt_state_dict_from_jax(grads)
    for name, p in pm.named_parameters():
        if p.requires_grad:
            p.grad = g[name].clone()
    opt.step()


def _assert_params(pm, params):
    want = gt_state_dict_from_jax(params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("clip,finetune", [(0.0, True), (0.4, True),
                                           (0.0, False)])
def test_dense_optimizer_matches_optax(clip, finetune):
    cfg, params, grads, pm, port_cfg = _opt_case(clip, finetune)
    if clip:          # each group's norm is above the clip: clipping acts
        norms = optax.global_norm(grads[0]["classifier"])
        assert float(norms) > clip
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
            idx = (int(name.split(".")[1]) if name.startswith("features.")
                   else None)
            if idx is None:
                assert moved, name                       # the head
            elif idx < 10 or not finetune:
                assert not moved, name                   # conv1/conv2
            else:
                assert moved == (k >= 3), (name, k)      # the encoder


def test_train_state_from_jax_resumes_like_optax():
    cfg, params, grads, pm, port_cfg = _opt_case(0.0)
    tx = jax_driver.make_dense_optimizer(cfg, 3)
    state = tx.init(params)
    for g in grads[:4]:                     # past the encoder's boundary
        upd, state = tx.update(g, state, params)
        params = _np(optax.apply_updates(params, upd))
    adam = {name: state.inner_states[name].inner_state[1]
            for name in ("encoder", "head")}
    adam = {k: (int(a.count), _np(a.mu), _np(a.nu)) for k, a in adam.items()}
    opt = dense_driver.make_dense_optimizer(port_cfg, pm, 3)
    sd, opt_sd = gt_train_state_from_jax(params, adam, opt)
    pm.load_state_dict(sd)
    opt.load_state_dict(opt_sd)
    upd, state = tx.update(grads[4], state, params)
    params = _np(optax.apply_updates(params, upd))
    _port_update(pm, opt, grads[4])
    _assert_params(pm, params)


def test_gradient_accumulation_is_refused():
    """grad_accum_steps 2 (once refused) builds: two micro-steps of
    gradients make one update by their mean, the weights unchanged after
    the first (the MultiSteps parity is in test_torch_grad_accum.py)."""
    cfg = get_gt_config().replace(grad_accum_steps=2, use_lstm=True)
    model = GTDenseCaptioner(**KW)
    opt = dense_driver.make_dense_optimizer(cfg, model, 3)
    assert opt.every == 2
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(0)
    grads = [{n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
              for n, p in model.named_parameters() if p.requires_grad}
             for _ in range(2)]
    for k, g in enumerate(grads):
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = g[n].clone()
        if opt.accumulate():
            for n, p in model.named_parameters():
                if p.requires_grad:       # the mean reached the optimizer
                    torch.testing.assert_close(
                        p.grad, grads[0][n] + (grads[1][n] - grads[0][n]) / 2,
                        rtol=0, atol=0)
            opt.step()
        moved = [not torch.equal(p, start[n])
                 for n, p in model.named_parameters()]
        assert any(moved) == (k == 1), k


def test_teacher_prob_schedule_matches_jax():
    for it in (0, 1, 5000, 200000):
        assert dense_driver.teacher_prob_schedule(it) == pytest.approx(
            float(jax_driver.teacher_prob_schedule(it)), rel=1e-6)


# ----------------------------------------------------------------- data

def test_vocab_and_synthetic_data_match_jax():
    caps = ["A man, riding a horse!", "the horse", "a man", "é½ café…"]
    want = jax_tokenizer.Vocab.from_captions(caps, min_token_instances=2)
    got = Vocab.from_captions(caps, min_token_instances=2)
    assert got.token_to_idx == want.token_to_idx
    for c in caps:
        np.testing.assert_array_equal(got.encode_caption(c, 6),
                                      want.encode_caption(c, 6))
    a1, i1 = synthetic.make_vg_arrays(num_images=7, seed=3)
    a2, i2 = jax_synthetic.make_vg_arrays(num_images=7, seed=3)
    assert i1 == i2 and sorted(a1) == sorted(a2)
    for k in a1:
        assert a1[k].dtype == a2[k].dtype and a1[k].tobytes() == \
            a2[k].tobytes(), k


@pytest.mark.parametrize("start", [0, 2, 3])
def test_padded_batches_match_jax(start):
    arrays, info = synthetic.make_vg_arrays(num_images=9, seed=4,
                                            regions_per_image=5)
    port = vg_loader.VGDataLoader(arrays=arrays, info=info)
    ref = jax_vg_loader.VGDataLoader(arrays=arrays, info=info)
    got = list(port.padded_batches(0, 2, max_regions=3, start=start))
    want = list(ref.padded_batches(0, 2, max_regions=3, start=start))
    assert len(got) == len(want) > 0
    for b1, b2 in zip(got, want):
        assert sorted(b1) == sorted(b2)
        for k in b1:
            assert b1[k].dtype == b2[k].dtype and b1[k].tobytes() == \
                b2[k].tobytes(), k
    # more regions than the slab holds: padded with the unit box, masked
    b = next(port.padded_batches(1, 1, max_regions=7))
    assert b["box_mask"].tolist() == [[1] * 5 + [0] * 2]
    assert (b["boxes"][0, 5:] == 8.0).all()


def test_hdf5_loader_matches_arrays(tmp_path):
    h5py = pytest.importorskip("h5py")
    arrays, info = synthetic.make_vg_arrays(num_images=5, seed=6)
    with h5py.File(tmp_path / "vg.h5", "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    (tmp_path / "vg.json").write_text(json.dumps(info))
    h5 = vg_loader.VGDataLoader(data_h5=str(tmp_path / "vg.h5"),
                                data_json=str(tmp_path / "vg.json"))
    mem = vg_loader.VGDataLoader(arrays=arrays, info=info)
    for b1, b2 in zip(h5.padded_batches(0, 1, 4), mem.padded_batches(0, 1, 4)):
        for k in b1:
            assert b1[k].tobytes() == b2[k].tobytes(), k


# ---------------------------------------------------------- checkpoints

def _train_objects(seed=0):
    model = seeded_init_(GTDenseCaptioner(**KW), seed)
    opt = dense_driver.make_dense_optimizer(
        get_gt_config().replace(vgg_stages=2), model, 1)
    gen = torch.Generator().manual_seed(seed)
    return model, opt, gen


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    model, opt, gen = _train_objects()
    step = dense_driver.make_gt_train_step(model, opt, False, gen)
    x, boxes, labels, mask = _inputs(5)
    u8 = torch.from_numpy(((x - x.min()) * 20).astype(np.uint8))
    for _ in range(2):
        step(u8, torch.from_numpy(boxes), torch.from_numpy(labels).long(),
             torch.from_numpy(mask), 1.0)
    path = str(tmp_path / "ckpt" / "gt.ckpt")
    ckptlib.save_checkpoint(path, ckptlib.train_state(
        model, opt, 2, gen, 4))
    assert os.listdir(tmp_path / "ckpt") == ["gt.ckpt"]
    model2, opt2, gen2 = _train_objects(seed=1)
    assert ckptlib.load_train_state(
        ckptlib.restore_checkpoint(path), model2, opt2, gen2) == (2, 4)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), n
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    assert s1["state"].keys() == s2["state"].keys()
    for k in s1["state"]:
        for name in s1["state"][k]:
            assert torch.equal(s1["state"][k][name], s2["state"][k][name])
    assert torch.equal(gen.get_state(), gen2.get_state())


def test_resume_path_preference_order(tmp_path):
    path = str(tmp_path / "best.ckpt")
    state = {"step": 1}
    assert ckptlib.resume_path(path) is None
    ckptlib.save_checkpoint(path, state)
    ckptlib.save_checkpoint(path, {"step": 2})        # overwrite: no leftovers
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt"]
    assert ckptlib.resume_path(path) == path
    assert ckptlib.restore_checkpoint(path) == {"step": 2}
    # a crash mid-swap: only .old is left
    os.rename(path, path + ".old")
    assert ckptlib.resume_path(path) == path + ".old"
    # a crash after the tmp file was written, before its swap: it wins
    time.sleep(0.02)
    shutil.copy(path + ".old", path + ".tmp-save")
    assert ckptlib.resume_path(path) == path + ".tmp-save"
    time.sleep(0.02)
    shutil.copy(path + ".old", path)
    assert ckptlib.resume_path(path) == path          # main file newer
    time.sleep(0.02)
    ckptlib.save_checkpoint(path + ".preempt", state)
    assert ckptlib.resume_path(path) == path + ".preempt"
    time.sleep(0.02)
    ckptlib.save_checkpoint(path, state)               # newer best
    assert ckptlib.resume_path(path) == path


def test_signal_checkpointer():
    prev = signal.getsignal(signal.SIGUSR1)
    with ckptlib.SignalCheckpointer(signals=(signal.SIGUSR1,)) as sig:
        assert signal.getsignal(signal.SIGUSR1) != prev
        assert not sig.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert sig.requested
    assert signal.getsignal(signal.SIGUSR1) == prev


# --------------------------------------------------------------- driver

def _cli_args(tmp_path, use_lstm=True, **extra):
    """traingt's key=value list; the LSTM head 32 wide, or (`use_lstm`
    False) the default config's transformer head at its default width."""
    kv = dict(data_h5=tmp_path / "missing.h5", data_json=tmp_path / "m.json",
              save_path=tmp_path / "models/best_gt.ckpt",
              loss_file=tmp_path / "loss_logs/loss_gt.json",
              result_file=tmp_path / "logs/results_gt.json", batch_size=2,
              max_regions=3, compute_dtype="float32", eval_batch_size=2,
              loss_log_pad=1, vgg_stages=2, **extra)
    if use_lstm:
        kv.update(rnn_size=32, input_encoding_size=32, use_lstm=True)
    return [f"{k}={v}" for k, v in kv.items()]


@pytest.mark.parametrize("use_lstm", [True, False])
def test_train_gt_writes_histories_and_resumes_from_preempt(tmp_path,
                                                            monkeypatch,
                                                            use_lstm):
    out = traingt.main(_cli_args(tmp_path, use_lstm, max_iters=2,
                                 use_curriculum_learning=True,
                                 save_checkpoint_every=2) +
                       ["--device", "cpu"])
    assert out["model"].use_lstm == use_lstm
    cfg = get_gt_config().replace(
        save_path=str(tmp_path / "models/best_gt.ckpt"),
        loss_file=str(tmp_path / "loss_logs/loss_gt.json"),
        result_file=str(tmp_path / "logs/results_gt.json"),
        use_lstm=use_lstm)
    loss_file, result_file, save_path = name_gt_model(cfg)
    assert out["iters"] == 2 and np.isfinite(out["final_loss"])
    assert out["best_val_score"] is not None
    assert os.path.isfile(loss_file) and os.path.isfile(result_file)
    assert os.path.isfile(save_path)                  # the best checkpoint
    assert ckptlib.restore_checkpoint(save_path)["step"] == 2
    assert [r["iter"] for r in json.loads(open(loss_file).read())] == [1, 2]

    # preempt the second run after its first step: SIGTERM arrives during
    # that step, the loop writes <save_path>.preempt at the next boundary
    real = dense_driver.teacher_prob_schedule

    def preempt_at_3(it):
        if it == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(it)
    monkeypatch.setattr(dense_driver, "teacher_prob_schedule", preempt_at_3)
    out = traingt.main(_cli_args(tmp_path, use_lstm, max_iters=6,
                                 from_checkpoint=True,
                                 save_checkpoint_every=6) +
                       ["--device", "cpu"])
    assert out["iters"] == 3 and os.path.isfile(save_path + ".preempt")
    assert ckptlib.resume_path(save_path) == save_path + ".preempt"
    assert ckptlib.restore_checkpoint(save_path + ".preempt")["step"] == 3
    monkeypatch.setattr(dense_driver, "teacher_prob_schedule", real)
    out = traingt.main(_cli_args(tmp_path, use_lstm, max_iters=4,
                                 from_checkpoint=True,
                                 save_checkpoint_every=4) +
                       ["--device", "cpu"])
    assert out["iters"] == 4
    assert [r["iter"] for r in json.loads(open(loss_file).read())] == [
        1, 2, 3, 4]


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        traingt.main(_cli_args(tmp_path, max_iters=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dense_driver.train_gt(get_gt_config())


def test_gt_evaluator_matches_jax():
    from imagecaptioning_tpu.eval import dense_eval as jax_eval
    from imagecaptioning_tpu_torch.eval import dense_eval

    rng = np.random.RandomState(8)
    got, want = (dense_eval.GTDenseCaptioningEvaluator(),
                 jax_eval.GTDenseCaptioningEvaluator())
    words = "a man red car on the street tree dog sits".split()
    for _ in range(3):
        boxes = np.stack([rng.uniform(20, 100, 6), rng.uniform(20, 100, 6),
                          rng.uniform(10, 60, 6), rng.uniform(10, 60, 6)], 1)
        boxes[1] = boxes[0] + 1.0              # two boxes merge at IoU ≥ 0.7
        caps = [" ".join(rng.choice(words, rng.randint(2, 6)))
                for _ in range(6)]
        refs = [" ".join(rng.choice(words, rng.randint(2, 6)))
                for _ in range(6)]
        got.addResult(boxes, caps, refs)
        want.addResult(boxes, caps, refs)
    assert [(r["ok"], r["candidate"], r["references"]) for r in got.records] \
        == [(r["ok"], r["candidate"], r["references"]) for r in want.records]
    g, w = got.evaluate(), want.evaluate()
    assert g["map"] == w["map"] and g["meteor"] == w["meteor"]
    assert g["ap_breakdown"] == w["ap_breakdown"] and g["map"] > 0


# --------------------------------------------------------- encoder_init

def _write_npz(path, tree):
    """A converted module's `.npz` in the JAX package's layout: its flax
    params under `params/`, `/`-joined."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)
    walk(tree, "params")
    np.savez(path, **flat)
    return str(path)


def test_encoder_init_features_and_classifier_match_jax(pair, tmp_path):
    """`features` and `classifier` written from the JAX model's own init
    into a differently seeded port model (its head from the same JAX
    params): the logits within 1e-4 of JAX's; a partial file raises in
    both packages."""
    from imagecaptioning_tpu.train.step import TrainState
    from imagecaptioning_tpu.utils import pretrained as jax_pretrained
    from imagecaptioning_tpu_torch.utils import pretrained

    jm, params, _, (x, boxes, labels, _) = pair
    features = _write_npz(tmp_path / "features.npz", params["features"])
    classifier = _write_npz(tmp_path / "classifier.npz", params["classifier"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(boxes), jnp.asarray(labels),
                               train=False).logits)
    model = seeded_init_(GTDenseCaptioner(**KW), 1)
    model.load_state_dict({k: v for k, v in gt_state_dict_from_jax(
        params).items() if k.startswith("llm.")}, strict=False)

    def logits():
        with torch.no_grad():
            return model(*_t(x, boxes), torch.from_numpy(labels).long()
                         ).logits.numpy()
    assert np.abs(logits() - want).max() > 1e-3
    pretrained.apply_encoder_init(model, f"{features},classifier={classifier}",
                                  "features")
    np.testing.assert_allclose(logits(), want, rtol=1e-4, atol=1e-4)
    state = TrainState(0, params, None, {}, None)
    jax_pretrained.apply_encoder_init(state, f"classifier={classifier}",
                                      "features")
    partial = dict(params["classifier"])
    del partial["fc7"]
    partial = _write_npz(tmp_path / "partial.npz", partial)
    for apply in (
            lambda: pretrained.apply_encoder_init(
                model, f"classifier={partial}", "features"),
            lambda: jax_pretrained.apply_encoder_init(
                state, f"classifier={partial}", "features")):
        with pytest.raises(ValueError, match="fc7"):
            apply()
