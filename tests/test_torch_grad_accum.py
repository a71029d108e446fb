"""Gradient accumulation (`grad_accum_steps`, optax's `MultiSteps`) in the
PyTorch port's three trainers against the JAX package, fp32 on the CPU at
tiny widths, and the port of the reference's functional optimizer updates.

- Each trainer's optimizer over its model's parameter names (the AlexCap
  LSTM with a VGGFace trunk, the GT model with the LSTM head, the RPN
  model; VGG stages 4 channels wide, fixed numpy gradients) against
  `optax.MultiSteps` at k = 2 over 4 micro-steps: weights and Adam moments
  within 1e-6 of optax after each applied update, the weights bitwise
  unchanged after each micro-step that ends no window.
- k = 2 at batch 2 equals k = 1 at batch 4 in the port (the VGGFace LSTM,
  no BatchNorm): the mean micro-loss within 1e-5 relative of the large
  batch's, the weights within 1e-4 relative + 1e-6.
- The finetune boundary in applied updates, with the drivers' rounding:
  the AlexCap driver's micro-step boundary up to a window's edge, the
  dense driver's encoder lr from `-(-train images // k)` updates on.
- A checkpoint saved mid-window resumes bitwise: the AlexCap train step
  end to end, and the dense optimizer alone.
- `optim_updates`: sgd, sgdm, sgdmom, adagrad, rmsprop and adam within
  1e-6 of JAX's over 5 updates.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecaptioning_tpu.config import configs as jax_configs
from imagecaptioning_tpu.config import dense_configs as jax_dense_configs
from imagecaptioning_tpu.train import dense_driver as jax_dense_driver
from imagecaptioning_tpu.train import optim as jax_optim
from imagecaptioning_tpu.train import optim_updates as jax_updates
from imagecaptioning_tpu_torch.config import configs, dense_configs
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.train import (dense_driver, driver, optim,
                                             optim_updates)
from imagecaptioning_tpu_torch.train.step import make_train_step
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.weights import (
    gt_state_dict_from_jax, lstm_captioner_state_dict_from_jax,
    rpn_state_dict_from_jax, seeded_init_)
import torch_threads  # noqa: F401  (one torch thread a test process)

K = 2                  # micro-steps per applied update
MICRO = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def no_checkpoint_files(monkeypatch):
    """The drivers' best-model checkpoints are not written (the boundary
    tests read none; a GT checkpoint with its Adam moments is ~0.8 GB)."""
    monkeypatch.setattr(ckptlib, "save_checkpoint", lambda path, state: None)


# ---------------------------------------- the optimizers against MultiSteps

def _module_from(sd):
    """An nn.Module whose parameters carry the names and values of the
    state dict `sd` (the optimizers see nothing but names)."""
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


def _vgg_shapes(stages=3, width=4):
    out, cin = {}, 3
    for stage, i in [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2),
                     (3, 3)][:{2: 4, 3: 7}[stages]]:
        out[f"conv{stage}_{i}"] = {"kernel": (3, 3, cin, width),
                                   "bias": (width,)}
        cin = width
    return out


LLM = {"image_encoder": {"kernel": (8, 6), "bias": (6,)},
       "lookup_table": {"embedding": (13, 6)},
       "lstm": {"w_ih_l0": (24, 6), "w_hh_l0": (24, 6),
                "b_ih_l0": (24,), "b_hh_l0": (24,)},
       "linear": {"kernel": (6, 13), "bias": (13,)}}
CLASSIFIER = {"fc6": {"kernel": (7 * 7 * 4, 8), "bias": (8,)},
              "fc7": {"kernel": (8, 8), "bias": (8,)}}


def _case(kind):
    """(the JAX chain at k, the port's optimizer over the model, the
    model, the JAX params, the micro-steps' gradients, the converter of a
    JAX tree to the port's names)."""
    if kind == "alexcap":
        shapes = {"features": _vgg_shapes(), "llm": LLM}
        kw = dict(use_vggface=True, learning_rate=3e-3, weight_decay=1e-4,
                  use_scheduler=False, clip_grad=True, grad_clip_norm=1.0,
                  finetune_cnn=True, grad_accum_steps=K)
        convert = lambda t: lstm_captioner_state_dict_from_jax(t, {})  # noqa
        tx = jax_optim.make_optimizer(
            jax_configs.get_lstm_config().replace(**kw), 2, 0)
        make = lambda cfg, pm: optim.make_optimizer(cfg, pm, 2)      # noqa
        port_cfg = configs.get_lstm_config().replace(**kw)
    else:
        kw = dict(learning_rate=1e-3, weight_decay=1e-2, finetune_cnn=True,
                  grad_accum_steps=K)
        if kind == "gt":
            shapes = {"features": _vgg_shapes(), "classifier": CLASSIFIER,
                      "llm": LLM}
            kw.update(use_lstm=True, grad_clip_norm=0.4)
            convert = gt_state_dict_from_jax
            jax_cfg = jax_dense_configs.get_gt_config().replace(**kw)
            port_cfg = dense_configs.get_gt_config().replace(**kw)
        else:
            shapes = {"conv_trunk": _vgg_shapes(),
                      "rpn_conv": {"kernel": (3, 3, 4, 6), "bias": (6,)},
                      "rpn_scores": {"kernel": (1, 1, 6, 3), "bias": (3,)},
                      "rpn_trans": {"kernel": (1, 1, 6, 12), "bias": (12,)},
                      "recog_base": CLASSIFIER,
                      "objectness": {"kernel": (8, 1), "bias": (1,)},
                      "box_reg": {"kernel": (8, 4), "bias": (4,)},
                      "llm": LLM}
            convert = rpn_state_dict_from_jax
            jax_cfg = jax_dense_configs.get_densecap_config().replace(**kw)
            port_cfg = dense_configs.get_densecap_config().replace(**kw)
        # the encoder's lr from applied update 1 on, inside the run
        tx = jax_dense_driver.make_dense_optimizer(jax_cfg, 1)
        make = lambda cfg, pm: dense_driver.make_dense_optimizer(   # noqa
            cfg, pm, 1)
    rng = np.random.RandomState(7)

    def draw(scale):
        return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = draw(0.1)
    grads = [draw(0.8 if kind == "alexcap" else 0.1) for _ in range(MICRO)]
    pm = _module_from(convert(params))
    return tx, make(port_cfg, pm), pm, params, grads, convert


def _adam_states(multi_steps_state):
    """{optax group label: its ScaleByAdamState} under a MultiSteps
    state."""
    out = {}

    def walk(node, group):
        if isinstance(node, optax.ScaleByAdamState):
            out[group] = node
        elif isinstance(node, optax.MultiTransformState):
            for g, s in node.inner_states.items():
                walk(s, g)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child, group)
    walk(multi_steps_state.inner_opt_state, None)
    return out


def _filled(params, tree):
    """`tree` shaped like `params`, zeros where it holds no array (a
    MaskedNode of another group)."""
    if isinstance(params, dict):
        return {k: _filled(v, tree.get(k) if isinstance(tree, dict)
                           else None) for k, v in params.items()}
    return np.asarray(tree) if hasattr(tree, "shape") else \
        np.zeros_like(params)


@pytest.mark.parametrize("kind", ["alexcap", "gt", "rpn"])
def test_accumulation_matches_optax_multisteps(kind):
    tx, opt, pm, params, grads, convert = _case(kind)
    assert opt.every == K
    state = tx.init(params)
    update = jax.jit(tx.update)           # one compile, not one a call
    trained = [p for p in pm.parameters() if p.requires_grad]
    for k, g in enumerate(grads):
        upd, state = update(g, state, params)
        params = _np(optax.apply_updates(params, upd))
        before = {n: p.detach().clone() for n, p in pm.named_parameters()}
        pg = convert(g)
        for name, p in pm.named_parameters():
            if p.requires_grad:
                p.grad = pg[name].clone()
        applied = opt.accumulate()
        assert applied == (k % K == K - 1)
        if applied:
            if kind == "alexcap":       # the step's clip, of the mean
                optim.clip_by_global_norm_(trained, 1.0)
            opt.step()
        else:
            assert all(p.grad is None for p in pm.parameters())
            for name, p in pm.named_parameters():
                assert torch.equal(p, before[name]), (name, k)
            continue
        want = convert(params)
        for name, p in pm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{name} micro-step {k}")
        adam = _adam_states(state)
        for group in opt.param_groups:
            st = adam[group["group"]]
            mu = convert(_filled(params, st.mu))
            nu = convert(_filled(params, st.nu))
            for name, p in zip(group["names"], group["params"]):
                s = opt.state[p]
                assert int(s["step"]) == int(st.count) == (k + 1) // K
                np.testing.assert_allclose(s["exp_avg"].numpy(),
                                           mu[name].numpy(), rtol=0,
                                           atol=1e-6, err_msg=name)
                np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                           nu[name].numpy(), rtol=0,
                                           atol=1e-6, err_msg=name)


# ------------------------------------------- k micro-batches = one batch

def test_accumulated_steps_equal_one_large_batch():
    v, t = 16, 5
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    gt = torch.from_numpy(rng.randint(1, v + 1, size=(4, t)))

    def make(accum):
        cfg = configs.get_lstm_config().replace(
            use_vggface=True, embedding_size=8, lstm_size=8,
            use_dropout=False, compute_dtype="float32",
            grad_accum_steps=accum)
        model = seeded_init_(build_model(cfg, v, t, device="cpu"), 0)
        opt = optim.make_optimizer(cfg, model, 100)
        return model, make_train_step(model, opt, clip_norm=1.0)

    big, step = make(1)
    loss_big = float(step(images, gt)["loss"])
    small, step = make(2)
    start = {n: p.detach().clone() for n, p in small.named_parameters()}
    loss1 = float(step(images[:2], gt[:2])["loss"])
    for n, p in small.named_parameters():
        assert torch.equal(p, start[n]), n        # no update mid-window
    loss2 = float(step(images[2:], gt[2:])["loss"])
    assert (loss1 + loss2) / 2 == pytest.approx(loss_big, rel=1e-5)
    want = dict(big.named_parameters())
    for n, p in small.named_parameters():
        assert not torch.equal(p, start[n]), n
        torch.testing.assert_close(p, want[n], rtol=1e-4, atol=1e-6,
                                   msg=n)


# ------------------------------------- the finetune boundary, applied units

def test_alexcap_finetune_boundary_is_rounded_to_a_window(
        tmp_path, monkeypatch, no_checkpoint_files):
    """3 iterations an epoch, finetuning after 1: the micro-step boundary
    3 goes up to 4, applied update 2; the optimizer's horizon is 3 applied
    updates for 6 micro-steps."""
    cfg = configs.get_lstm_config().replace(
        data_h5="/nonexistent", save_checkpoint_every=6, batch_size=2,
        eval_val_batch_size=2, num_epochs=2, finetuning_after_nepoch=1,
        backbone_stages=(1, 1, 1, 1), embedding_size=16, lstm_size=16,
        compute_dtype="float32", grad_accum_steps=K,
        save_path=str(tmp_path / "m.ckpt"),
        loss_file=str(tmp_path / "l.json"),
        result_file=str(tmp_path / "r.json"))
    seen, horizon = [], []
    make_step, make_opt = driver.make_train_step, optim.make_optimizer

    def recording_step(model, *a, **k):
        step = make_step(model, *a, **k)

        def run(images, labels):
            out = step(images, labels)
            seen.append((model.freeze_encoder,
                         model.features[0].weight.detach().clone(),
                         model.features[1].running_mean.clone()))
            return out
        return run

    def recording_opt(cfg, model, total_steps):
        horizon.append(total_steps)
        return make_opt(cfg, model, total_steps)
    monkeypatch.setattr(driver, "make_train_step", recording_step)
    monkeypatch.setattr(optim, "make_optimizer", recording_opt)
    out = driver.train(cfg, device="cpu", synthetic_images=16,
                       verbose=False)
    assert out["iters"] == 6 and horizon == [3]
    assert out["optimizer"].param_groups[0]["updates"] == 3
    assert [f for f, _, _ in seen] == [True] * 4 + [False] * 2
    w0 = seen[0][1]
    # the trunk stays put through applied update 2, moves at 3
    assert all(torch.equal(w, w0) for _, w, _ in seen[:4])
    assert not torch.equal(seen[5][1], w0)
    # BatchNorm's statistics move at every micro-step after the boundary
    stats = [s for _, _, s in seen]
    assert all(torch.equal(s, stats[0]) for s in stats[:4])
    assert not torch.equal(stats[4], stats[3])
    assert not torch.equal(stats[5], stats[4])


def test_dense_encoder_boundary_is_in_applied_updates(
        tmp_path, monkeypatch, no_checkpoint_files):
    """3 train images at k = 2: the encoder's lr from applied update
    -(-3 // 2) = 2 on, so conv3_1 stays put through micro-step 4 and moves
    at micro-step 6; conv1/conv2 never move."""
    cfg = dense_configs.get_gt_config().replace(
        use_lstm=True, input_encoding_size=16, rnn_size=16, vgg_stages=3,
        compute_dtype="float32", batch_size=1, max_regions=4,
        grad_accum_steps=K, data_h5=str(tmp_path / "missing.h5"),
        loss_file=str(tmp_path / "l.json"),
        result_file=str(tmp_path / "r.json"),
        save_path=str(tmp_path / "m.ckpt"))
    seen = []
    make_step = dense_driver.make_gt_train_step

    def recording_step(model, *a, **k):
        step = make_step(model, *a, **k)

        def run(*args):
            out = step(*args)
            seen.append((model.features[0].weight.detach().clone(),
                         model.features[10].weight.detach().clone()))
            return out
        return run
    monkeypatch.setattr(dense_driver, "make_gt_train_step", recording_step)
    out = dense_driver.train_gt(cfg, device="cpu", max_iter_override=6,
                                eval_every_override=6, synthetic_images=5,
                                verbose=False)
    assert len(out["loader"].train_ix) == 3 and out["iters"] == 6
    enc = out["optimizer"].param_groups[1]
    assert enc["group"] == "encoder" and enc["start_step"] == 2
    conv1, conv3 = seen[0]
    assert all(torch.equal(c1, conv1) for c1, _ in seen)
    assert all(torch.equal(c3, conv3) for _, c3 in seen[:4])
    assert not torch.equal(seen[5][1], conv3)


# ------------------------------------------- a checkpoint saved mid-window

def _alexcap_setup():
    cfg = configs.get_lstm_config().replace(
        backbone_stages=(1, 1, 1, 1), embedding_size=16, lstm_size=16,
        compute_dtype="float32", use_dropout=True, grad_accum_steps=K)
    model = seeded_init_(build_model(cfg, 20, 6, device="cpu"), 0)
    opt = optim.make_optimizer(cfg, model, 10)
    gen = torch.Generator().manual_seed(1)
    step = make_train_step(model, opt, gen, clip_norm=1.0)
    rng = np.random.RandomState(3)
    batches = [(torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32)),
                torch.from_numpy(rng.randint(1, 21, (2, 6))))
               for _ in range(MICRO + 1)]
    return model, opt, gen, lambda b: step(*b)["loss"], batches


def _dense_setup():
    """The dense optimizer alone, over the GT model's parameter names
    (`_case`: narrow VGG stages, fixed gradients): its window's state
    without a 4096-wide classifier to write."""
    _, opt, model, _, grads, convert = _case("gt")

    def run(g):
        pg = convert(g)
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = pg[name].clone()
        if opt.accumulate():
            opt.step()
        return torch.cat([p.detach().flatten() for p in model.parameters()])
    return model, opt, torch.Generator().manual_seed(1), run, grads + grads[:1]


@pytest.mark.parametrize("kind", ["alexcap", "dense"])
def test_checkpoint_saved_mid_window_resumes_bitwise(tmp_path, kind):
    setup = {"alexcap": _alexcap_setup, "dense": _dense_setup}[kind]
    model, opt, gen, run, batches = setup()
    run(batches[0])                       # one micro-step into a window
    assert opt.mini_step == 1 and opt.means
    path = str(tmp_path / "mid.ckpt")
    ckptlib.save_checkpoint(path, ckptlib.train_state(model, opt, 1, gen, 2))
    model2, opt2, gen2, run2, _ = setup()
    assert ckptlib.load_train_state(
        ckptlib.restore_checkpoint(path, torch.device("cpu")),
        model2, opt2, gen2) == (1, 2)
    os.remove(path)
    assert opt2.mini_step == 1
    for b in batches[1:]:
        assert torch.equal(run(b), run2(b))
    assert torch.equal(gen.get_state(), gen2.get_state())
    for (n, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), n
    # two applied updates, then one micro-step into the third window
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["accumulation"]["mini_step"] == s2["accumulation"][
        "mini_step"] == 1
    assert sorted(s1["accumulation"]["means"]) == sorted(
        s2["accumulation"]["means"]) != []
    for k in s1["accumulation"]["means"]:
        assert torch.equal(s1["accumulation"]["means"][k],
                           s2["accumulation"]["means"][k]), k
    for i, st in s1["state"].items():
        for key, v in st.items():
            assert torch.equal(v, s2["state"][i][key]), (i, key)


# ------------------------------------------------------- optim_updates

@pytest.mark.parametrize("name", ["sgd", "sgdm", "sgdmom", "adagrad",
                                  "rmsprop", "adam"])
def test_optim_updates_match_jax(name):
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js = ts = None
    if name != "sgd":
        js = getattr(jax_updates, f"{name}_init")(jp)
        ts = getattr(optim_updates, f"{name}_init")(tp)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if name == "sgd":
            jp, tp = jax_updates.sgd(jp, jg, 0.1), optim_updates.sgd(tp, tg,
                                                                     0.1)
        else:
            jp, js = getattr(jax_updates, name)(jp, jg, js, 0.1)
            tp, ts = getattr(optim_updates, name)(tp, tg, ts, 0.1)
    for k in params:
        assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
