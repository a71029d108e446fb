"""The PyTorch port's AlexCap LSTM captioner against the JAX package, at a
tiny size (ResNet stages (1, 1, 1, 1), head widths 16-24, vocabulary 20,
batch 2), fp32 on the CPU.

Same numpy inputs, the JAX weights carried over by
`lstm_captioner_state_dict_from_jax` (BatchNorm's running statistics
included, drawn away from their init so that they matter):
- `resnet_v2_preprocess`: upsampling at CelebA's 218×178, downsampling,
  and the edges (no resize, a tall image, a one-pixel-off short side),
  within 1e-5;
- the ResNet trunk in eval mode within 1e-4; in training mode outputs
  within 1e-4 and the updated running mean and (biased) variance within
  1e-5;
- teacher-forced logits within 1e-4; `smoothed_cross_entropy` within
  1e-5 (and against torch's own `CrossEntropyLoss(label_smoothing=0.1)`);
- the loss within 1e-5 and every gradient within 1e-4 relative (max
  |got − want| ≤ 1e-4 · max |want| per tensor) in the finetune phase
  (BatchNorm on batch statistics) and the frozen one (the trunk's
  gradients None in the port, zeros in JAX);
- greedy and beam-3 (raw-logit) tokens identical, beam scores within 1e-4;
- the VGGFace encoder's logits within 1e-4;
- the converted state dict equal to the JAX package's own reference-layout
  export (`export_sequential_resnet` + `export_reference_lstm_head`).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.data import transforms as jax_transforms
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.models.backbones.resnet import \
    ResNetFeatures as JaxResNet
from imagecaptioning_tpu.models.captioners import LSTMCaptioner as JaxLSTM
from imagecaptioning_tpu.ops import losses as jax_losses
from imagecaptioning_tpu.utils import torch_port
from imagecaptioning_tpu_torch.data import transforms
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.backbones.resnet import ResNetFeatures
from imagecaptioning_tpu_torch.models.captioners import LSTMCaptioner
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops import losses
from imagecaptioning_tpu_torch.utils.weights import (
    lstm_captioner_state_dict_from_jax, resnet_state_dict)
import torch_threads  # noqa: F401  (one torch thread a test process)

STAGES = (1, 1, 1, 1)
KW = dict(vocab_size=20, embedding_size=24, rnn_size=16)
SEQ = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, rng, kind):
    """Move BatchNorm's scale/bias or its statistics off their init."""
    def leaf(path, a):
        name = str(path[-1].key)
        if kind == "stats":
            return (rng.uniform(0.5, 1.5, a.shape) if name == "var"
                    else rng.randn(*a.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias" and a.ndim == 1 and "bn" in str(path[-2].key):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _images(seed=0, n=2, size=64):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _labels(seed=0, n=2):
    rng = np.random.RandomState(seed + 7)
    gt = rng.randint(1, KW["vocab_size"] + 1, (n, SEQ)).astype(np.int32)
    gt[1, 3:] = 0                                    # a short caption
    return gt


def _jax_variables(model, x, gt, seed=0):
    k = jax.random.PRNGKey(seed)
    v = jax.jit(partial(model.init, train=False))(
        {"params": k, "dropout": k}, jnp.asarray(x), jnp.asarray(gt))
    rng = np.random.RandomState(seed + 1)
    out = {"params": _perturb(_np(v["params"]), rng, "params")}
    if "batch_stats" in v:
        out["batch_stats"] = _perturb(_np(v["batch_stats"]), rng, "stats")
    return out


@pytest.fixture(scope="module")
def pair():
    """(jax model, its variables, the port's model, images, labels)."""
    x, gt = _images(), _labels()
    jm = JaxLSTM(backbone_stages=STAGES, **KW)
    variables = _jax_variables(jm, x, gt)
    pm = LSTMCaptioner(backbone_stages=STAGES, **KW)
    pm.load_state_dict(lstm_captioner_state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    return jm, variables, pm.eval(), x, gt


# ------------------------------------------------------ module 1: preprocess

@pytest.mark.parametrize("hw", [
    pytest.param((218, 178), id="celeba-upsample"),
    pytest.param((400, 300), id="downsample"),
    pytest.param((232, 300), id="short-side-already-232"),
    pytest.param((300, 150), id="tall-upsample"),
    pytest.param((233, 480), id="downsample-by-one-pixel"),
])
def test_preprocess_matches_jax(hw):
    rng = np.random.RandomState(sum(hw))
    images = rng.randint(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_transforms.resnet_v2_preprocess(
        jnp.asarray(images)))
    got = transforms.resnet_v2_preprocess(torch.from_numpy(images))
    assert got.shape == (2, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_preprocess_rounds_once_to_bf16():
    images = np.random.RandomState(1).randint(0, 256, (1, 218, 178, 3),
                                              dtype=np.uint8)
    x = torch.from_numpy(images)
    got = transforms.resnet_v2_preprocess(x, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, transforms.resnet_v2_preprocess(x).to(
        torch.bfloat16))


# ---------------------------------------------------- module 2: the trunk

def _resnet_pair(stages, seed=0, size=64):
    x = _images(seed, size=size)
    jr = JaxResNet(stage_sizes=stages)
    v = jax.jit(partial(jr.init, train=False))(jax.random.PRNGKey(seed),
                                               jnp.asarray(x))
    rng = np.random.RandomState(seed + 1)
    params = _perturb(_np(v["params"]), rng, "params")
    stats = _perturb(_np(v["batch_stats"]), rng, "stats")
    pr = ResNetFeatures(stages)
    pr.load_state_dict({k.split(".", 1)[1]: t for k, t in
                        resnet_state_dict(params, stats).items()})
    return jr, {"params": params, "batch_stats": stats}, pr, x


@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (2, 1, 1, 2)])
def test_resnet_eval_mode_matches_jax(stages):
    jr, variables, pr, x = _resnet_pair(stages)
    want = np.asarray(jr.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pr(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_resnet_train_mode_and_running_stats_match_jax():
    jr, variables, pr, x = _resnet_pair((2, 1, 1, 1), seed=3)
    want, mutated = jr.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = pr(torch.from_numpy(x), train=True).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    new_stats = _np(mutated["batch_stats"])
    want_sd = resnet_state_dict(variables["params"], new_stats)
    got_sd = pr.state_dict()
    for name, t in want_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[name.split(".", 1)[1]].numpy(),
                                       t.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def test_batchnorm_updates_with_the_biased_variance():
    from imagecaptioning_tpu_torch.models.backbones.resnet import BatchNorm2d
    bn = BatchNorm2d(3)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 4, 5)
                         .astype(np.float32))
    bn(x, train=True)
    var = x.numpy().transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1, ddof=0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    before = bn.running_mean.clone()
    bn(x, train=False)                               # eval: no update
    assert torch.equal(bn.running_mean, before)


# ------------------------------------------ modules 3-5: head, model, loss

def test_output_dropout_is_alexcap_only():
    torch.manual_seed(0)
    head = LanguageHead(10, 8, 8, dropout=0.5, image_dim=6,
                        output_dropout=True)
    feats, toks = torch.randn(2, 3, 6), torch.randint(1, 10, (2, 4))
    g = torch.Generator().manual_seed(0)
    drop = head(feats, toks, generator=g, train=True)
    keep = head(feats, toks, train=False)
    assert not torch.allclose(drop, keep)
    gt_head = LanguageHead(10, 8, 8, dropout=0.5, image_dim=6)
    gt_head.load_state_dict(head.state_dict())
    assert gt_head.out_drop == 0.0
    assert torch.equal(gt_head(feats, toks, train=True), keep)


def test_teacher_forced_logits_match_jax(pair):
    jm, variables, pm, x, gt = pair
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(gt),
                               train=False).logits)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(gt)).logits.numpy()
    assert got.shape == (2, SEQ + 1, KW["vocab_size"] + 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_smoothed_cross_entropy_matches_jax_and_torch():
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 7, 23).astype(np.float32) * 3
    targets = rng.randint(0, 23, (4, 7)).astype(np.int32)
    targets[0, 2:] = 0
    want = float(jax_losses.smoothed_cross_entropy(jnp.asarray(logits),
                                                   jnp.asarray(targets)))
    got = float(losses.smoothed_cross_entropy(torch.from_numpy(logits),
                                              torch.from_numpy(targets)))
    assert abs(got - want) <= 1e-5 * abs(want)
    ref = torch.nn.CrossEntropyLoss(ignore_index=0, label_smoothing=0.1)(
        torch.from_numpy(logits).reshape(-1, 23),
        torch.from_numpy(targets).reshape(-1).long())
    assert abs(got - float(ref)) <= 1e-5 * abs(got)


@pytest.mark.parametrize("frozen", [False, True], ids=["finetune", "frozen"])
def test_loss_and_every_gradient_match_jax(pair, frozen):
    jm0, variables, pm, x, gt = pair
    jm = JaxLSTM(backbone_stages=STAGES, freeze_encoder=frozen, **KW)

    def loss_fn(p):
        out, _ = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), jnp.asarray(gt), train=True,
                          mutable=["batch_stats"])
        return jm.loss(out, jnp.asarray(gt))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, variables["params"]))
    want = lstm_captioner_state_dict_from_jax(_np(want_grads),
                                              variables["batch_stats"])

    model = LSTMCaptioner(backbone_stages=STAGES, freeze_encoder=frozen,
                          **KW)
    model.load_state_dict(pm.state_dict())
    out = model(torch.from_numpy(x), torch.from_numpy(gt), train=True)
    loss = model.loss(out, torch.from_numpy(gt))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if frozen and name.startswith("features."):
            assert p.grad is None and not np.any(w), name
            continue
        assert p.grad is not None and np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_vggface_encoder_matches_jax():
    x, gt = _images(2, size=32), _labels(2)
    jm = JaxLSTM(use_vggface=True, **KW)
    variables = _jax_variables(jm, x, gt)
    pm = LSTMCaptioner(use_vggface=True, **KW).eval()
    pm.load_state_dict(lstm_captioner_state_dict_from_jax(
        variables["params"], {}))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(gt),
                               train=False).logits)
    with torch.no_grad():
        feats = pm.encode(torch.from_numpy(x))
        got = pm(torch.from_numpy(x), torch.from_numpy(gt)).logits.numpy()
    assert feats.shape == (2, 4, 512)        # a 2×2 grid of VGG16's conv5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------- module 6: decoding

def test_greedy_and_beam_tokens_match_jax(pair):
    jm, variables, pm, x, _ = pair
    jx = jnp.asarray(x)
    steps = SEQ + 1
    want_greedy, _ = jax_api.make_greedy_fn(jm, steps)(variables, jx)
    want_beam = jax_api.make_beam_fn(jm, steps, 3)(variables, jx)
    tx = torch.from_numpy(x)
    got_greedy = api.make_greedy_fn(pm, steps)(tx)
    got_beam = api.make_beam_fn(pm, steps, 3)(tx)
    np.testing.assert_array_equal(got_greedy.numpy(),
                                  np.asarray(want_greedy))
    np.testing.assert_array_equal(got_beam.tokens.numpy(),
                                  np.asarray(want_beam.tokens))
    np.testing.assert_array_equal(got_beam.finished.numpy(),
                                  np.asarray(want_beam.finished))
    np.testing.assert_allclose(got_beam.scores.numpy(),
                               np.asarray(want_beam.scores), rtol=1e-4,
                               atol=1e-4)
    # raw-logit scores: not log-probabilities (those are all ≤ 0)
    assert float(got_beam.scores.max()) > 0


# ------------------------------------------- module 16: reference layout

def test_state_dict_is_the_reference_layout(pair):
    _, variables, pm, _, _ = pair
    sd = lstm_captioner_state_dict_from_jax(variables["params"],
                                            variables["batch_stats"])
    want = torch_port.export_sequential_resnet(
        {"params": variables["params"]["features"],
         "batch_stats": variables["batch_stats"]["features"]})
    want.update(torch_port.export_reference_lstm_head(
        variables["params"]["llm"]))
    assert sorted(sd) == sorted(want) == sorted(pm.state_dict())
    for name, t in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(t),
                                      err_msg=name)
    for key in ("features.0.weight", "features.1.running_var",
                "features.4.0.downsample.0.weight",
                "features.7.0.bn3.num_batches_tracked",
                "llm.image_encoder.encode.weight", "llm.lookup_table.weight",
                "llm.lstm.weight_hh_l0", "llm.rnn.linear.bias"):
        assert key in sd
