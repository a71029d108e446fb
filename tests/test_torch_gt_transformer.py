"""The PyTorch port's GT transformer head (`GTDenseCaptioner(use_lstm=
False)`) against the JAX package, at a tiny size, fp32.

One JAX init (2 VGG stages, 32×32 images, embed_size 32, 2 encoder and 2
decoder layers, 4 heads, vocab 24, seq 5) is carried over with
`gt_state_dict_from_jax`, and both sides run on the same numpy inputs:
- `make_trg_mask`: equal;
- teacher-forced logits and region codes: atol and rtol 1e-4 (VGG and the
  4096-wide classifier sum in another order);
- the cached decode step against the port's own teacher-forced logits on
  NULL-free tokens: 1e-5;
- greedy region tokens: identical; beam-3 tokens and finished flags:
  identical, scores within 1e-5;
- the loss within 1e-5 and every parameter's gradient within 1e-4
  relative (max |got − want| ≤ 1e-4 · max |want| per tensor) of
  `jax.value_and_grad`;
- one `DenseAdam` update, and one after `gt_train_state_from_jax`,
  within 1e-6 of optax at lr 1e-3, weight decay off. With it on, an
  element whose gradient cancels the decay term (g + wd·p within rounding
  of 0, next to Adam's eps 1e-8) takes a first update anywhere in
  [−lr, lr] on either side: torch adds the decay with one rounding, optax
  with two (one of fc6's 25.7 M weights came out 1.1e-6 apart). Where the
  decay acts is held by `test_torch_gt_train.py`'s optimizer tests;
- a reference-layout export (the JAX package's
  `export_reference_gt_model`: the encoder's dead word embedding and its
  full position table) through `load_gt_checkpoint` and a strict
  `load_state_dict`.
Also: a fully masked score row comes out uniform (no NaN), dropout draws
from the generator and acts only in training, and `teacher_prob` changes
nothing for this head.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecaptioning_tpu.config.dense_configs import \
    get_gt_config as jax_gt_config
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.models.densecap import GTDenseCaptioner as JaxGT
from imagecaptioning_tpu.ops import transformer as jax_transformer
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu.utils import torch_port
from imagecaptioning_tpu_torch.config.dense_configs import get_gt_config
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.ops import tokens, transformer
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils.weights import (gt_state_dict_from_jax,
                                                     gt_train_state_from_jax,
                                                     load_gt_checkpoint,
                                                     vgg_classifier_state_dict)

KW = dict(vocab_size=24, seq_length=5, vgg_stages=2, embed_size=32,
          num_layers=2, heads=4)
STEPS = KW["seq_length"] + 1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model (eval), inputs)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    boxes = np.stack([rng.uniform(4, 28, (2, 4)), rng.uniform(4, 28, (2, 4)),
                      rng.uniform(4, 24, (2, 4)), rng.uniform(4, 24, (2, 4))],
                     axis=-1).astype(np.float32)
    boxes[1, 3] = 1.0                                      # a pad box
    labels = rng.randint(1, KW["vocab_size"] + 1, (2, 4, KW["seq_length"]))
    labels[0, 2, 3:] = 0                                   # a short caption
    labels[1, 0, :] = 0                                    # an empty one
    mask = np.ones((2, 4), np.float32)
    mask[1, 3] = 0.0                                       # a padded region
    jm = JaxGT(use_lstm=False, **KW)
    k = jax.random.PRNGKey(0)
    v = jax.jit(jm.init)({"params": k, "sampling": k}, jnp.asarray(x),
                         jnp.asarray(boxes),
                         jnp.asarray(labels.astype(np.int32)))
    params = _np(v["params"])
    pm = GTDenseCaptioner(use_lstm=False, **KW).eval()
    pm.load_state_dict(gt_state_dict_from_jax(params))
    return jm, params, pm, (x, boxes, labels.astype(np.int32), mask)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("trg", [
    [[25, 3, 4, 0, 0], [25, 0, 7, 1, 2], [25, 1, 1, 1, 1]],
    [[0, 0, 0, 0, 0], [25, 2, 0, 0, 0], [25, 1, 0, 3, 0]],
], ids=["trailing_and_inner_nulls", "all_null_row"])
def test_make_trg_mask_matches_jax(trg):
    trg = np.array(trg, np.int32)
    want = jax_transformer.make_trg_mask(jnp.asarray(trg), True)
    got = transformer.make_trg_mask(torch.from_numpy(trg))
    assert got.shape == (3, 1, 5, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fully_masked_row_is_uniform_not_nan():
    att = transformer.MultiHeadAttention(8, 2)
    rng = np.random.RandomState(1)
    q, kv = _t(rng.randn(1, 2, 8).astype(np.float32),
               rng.randn(1, 3, 8).astype(np.float32))
    masked = torch.tensor([[False, True, False], [True, True, True]])
    with torch.no_grad():
        got = att(kv, kv, q, masked)
        k, v = att.project_kv(kv, kv)
        mean_v = att.fc_out(v.mean(dim=1).reshape(1, 8))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0, 1], mean_v[0], rtol=1e-6, atol=1e-6)


def test_teacher_forced_logits_match_jax(pair):
    jm, params, pm, (x, boxes, labels, _) = pair
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(boxes),
                    jnp.asarray(labels), train=False)
    with torch.inference_mode():
        got = pm(*_t(x, boxes), torch.from_numpy(labels).long())
    assert got.logits.shape == (2, 4, STEPS, KW["vocab_size"] + 3)
    np.testing.assert_allclose(got.region_codes.numpy(),
                               np.asarray(want.region_codes),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-4, atol=1e-4)


def test_cached_decode_step_matches_teacher_forcing(pair):
    """Step t of the cached decode gives the teacher-forced logits at t
    when no token is NULL (the step masks no key; teacher forcing masks
    NULL keys)."""
    _, _, pm, (x, boxes, _, _) = pair
    rng = np.random.RandomState(2)
    toks = torch.from_numpy(rng.randint(1, KW["vocab_size"] + 3, (8, STEPS)))
    toks[:, 0] = pm.spec.start
    with torch.inference_mode():
        enc = pm.encode_flat(*_t(x, boxes))
        forced = pm.llm.decoder(toks, enc)
        carry, step = pm.init_decode(enc)
        stepped = []
        for t in range(STEPS):
            carry, logits = step(carry, toks[:, t:t + 1], t)
            stepped.append(logits)
    torch.testing.assert_close(torch.stack(stepped, 1), forced, rtol=1e-5,
                               atol=1e-5)


def test_greedy_region_decode_matches_jax(pair):
    jm, params, pm, (x, boxes, _, _) = pair
    want = jax_api.make_region_greedy_fn(jm, STEPS)(
        {"params": params}, jnp.asarray(x), jnp.asarray(boxes))
    got = api.make_region_greedy_fn(pm, STEPS)(*_t(x, boxes))
    assert got.shape == (8, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam3_region_decode_matches_jax(pair):
    jm, params, pm, (x, boxes, _, _) = pair
    want = jax_api.make_region_beam_fn(jm, STEPS, 3)(
        {"params": params}, jnp.asarray(x), jnp.asarray(boxes))
    got = api.make_region_beam_fn(pm, STEPS, 3)(*_t(x, boxes))
    assert got.tokens.shape == (8, 3, STEPS)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.finished.numpy(),
                                  np.asarray(want.finished))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_grads(pair):
    """(loss, grads) of the JAX model at the pair's params and inputs."""
    jm, params, _, (x, boxes, labels, mask) = pair

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(boxes),
                       jnp.asarray(labels), train=False)
        return jm.loss(out, jnp.asarray(labels), jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), _np(grads)


def test_loss_and_every_gradient_match_jax(pair, jax_grads):
    _, _, pm, (x, boxes, labels, mask) = pair
    want_loss, grads = jax_grads
    want = gt_state_dict_from_jax(grads)
    model = copy.deepcopy(pm)
    tx, tb, tl, tm = _t(x, boxes, labels, mask)
    out = model(tx, tb, tl.long())
    loss = model.loss(out, tl.long(), tm)
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-5
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    live = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        live += np.abs(w).max() > 0
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    # a softmax over the one encoder position passes no gradient to the
    # queries and keys that score it; every other tensor gets one
    assert live == len(names) - 4 * KW["num_layers"]


def _port_optimizer(pm):
    """A copy of the port's model and its DenseAdam at lr 1e-3, weight
    decay off, every group moving from the first update."""
    model = copy.deepcopy(pm)
    cfg = get_gt_config().replace(learning_rate=1e-3, weight_decay=0.0)
    return model, dense_driver.make_dense_optimizer(cfg, model, 0)


def _port_update(model, opt, grads):
    g = gt_state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = g[name].clone()
    opt.step()


def _assert_params(model, params):
    want = gt_state_dict_from_jax(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def first_update(pair, jax_grads):
    """One update of the JAX gradients on both sides → (optax transform,
    its state and params after it, the port's model and DenseAdam)."""
    _, params, pm, _ = pair
    cfg = jax_gt_config().replace(learning_rate=1e-3, weight_decay=0.0)
    tx = jax_driver.make_dense_optimizer(cfg, 0)
    upd, state = jax.jit(tx.update)(jax_grads[1], tx.init(params), params)
    model, opt = _port_optimizer(pm)
    _port_update(model, opt, jax_grads[1])
    return tx, state, _np(optax.apply_updates(params, upd)), model, opt


def test_dense_adam_update_matches_optax(first_update):
    _, _, params, model, opt = first_update
    _assert_params(model, params)
    # a 2-stage trunk is conv1/conv2 only, frozen: the head is the group
    assert [g["group"] for g in opt.param_groups] == ["head"]
    head = opt.param_groups[0]["names"]
    assert any(n.startswith("llm.decoder.") for n in head)
    assert not any(n.startswith("features.") for n in head)


def test_train_state_from_jax_resumes_like_optax(pair, jax_grads,
                                                 first_update):
    tx, state, params, _, _ = first_update
    adam = {name: state.inner_states[name].inner_state[1]
            for name in ("encoder", "head")}
    adam = {k: (int(a.count), _np(a.mu), _np(a.nu)) for k, a in adam.items()}
    model, opt = _port_optimizer(pair[2])
    sd, opt_sd = gt_train_state_from_jax(params, adam, opt)
    model.load_state_dict(sd)
    opt.load_state_dict(opt_sd)
    grads = jax.tree.map(lambda g: -0.5 * g, jax_grads[1])
    upd, _ = jax.jit(tx.update)(grads, state, params)
    _port_update(model, opt, grads)
    _assert_params(model, _np(optax.apply_updates(params, upd)))


def test_reference_layout_export_loads_strict(pair, tmp_path, monkeypatch):
    """The JAX package's reference export (its trunk and classifier
    exporters hard-code a 5-stage trunk, so at 2 stages the trunk's is
    called with its `end_stage` and the port's channel-reading classifier
    converter stands in) → `load_gt_checkpoint` → strict load."""
    _, params, pm, _ = pair
    export_features = torch_port.export_vgg_features

    def export_classifier(variables, prefix="classifier"):
        sd = vgg_classifier_state_dict(variables["params"], channels=128,
                                       prefix=prefix)
        return {k: v.numpy() for k, v in sd.items()}
    monkeypatch.setattr(torch_port, "export_vgg_features",
                        lambda v, prefix: export_features(v, prefix, 2))
    monkeypatch.setattr(torch_port, "export_vgg_classifier",
                        export_classifier)
    sd, meta = torch_port.export_reference_gt_model({"params": params})
    assert meta["use_lstm"] is False
    assert sd["llm.encoder.position_embedding.weight"].shape == (STEPS, 32)
    assert "llm.encoder.word_embedding.weight" in sd
    path = tmp_path / "gt_transformer.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(path))
    model = GTDenseCaptioner(use_lstm=False, **KW).eval()
    model.load_state_dict(load_gt_checkpoint(str(path)), strict=True)
    for name, p in pm.state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name


def test_dropout_draws_from_the_generator_and_teacher_prob_is_ignored(pair):
    _, _, pm, (x, boxes, labels, _) = pair
    model = GTDenseCaptioner(use_lstm=False, dropout=0.5, **KW)
    model.load_state_dict(pm.state_dict())
    model.classifier[2].p = 0.0          # only the head's dropout acts
    tx, tb, tl = _t(x, boxes, labels)
    tl = tl.long()
    with torch.no_grad():
        ev = model(tx, tb, tl).logits
        tr = [model(tx, tb, tl, train=True,
                    generator=torch.Generator().manual_seed(s)).logits
              for s in (0, 0, 1)]
        sampled = model(tx, tb, tl, train=True, teacher_prob=0.0,
                        generator=torch.Generator().manual_seed(0)).logits
    assert torch.equal(ev, pm(tx, tb, tl).logits)       # no dropout at eval
    assert torch.equal(tr[0], tr[1]) and not torch.equal(tr[0], tr[2])
    assert not torch.equal(tr[0], ev)
    assert torch.equal(sampled, tr[0])        # no scheduled sampling here
    assert pm.spec == tokens.TokenSpec(27, 0, 25, 26, 30)   # over V+3
