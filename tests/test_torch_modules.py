"""Module-by-module parity of the PyTorch port against the JAX package.

Each JAX module is initialised from a fixed key, its params are carried
over with the port's converter (`utils.weights`), and both run on the
same numpy inputs. Tolerances (fp32 on both sides, JAX at "highest"
matmul precision):
- VGG trunk and classifier head: atol 1e-4 (3×3 convs and 4096-wide
  products summed in another order by each framework's CPU kernels);
- LSTM and the LSTM caption head: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.data import tokenizer as jax_tokenizer
from imagecaptioning_tpu.data import proposals as jax_proposals
from imagecaptioning_tpu.data.vg_loader import normalize_images as jax_normalize
from imagecaptioning_tpu.models.backbones import vgg as jax_vgg
from imagecaptioning_tpu.models.heads import LanguageHead as JaxLanguageHead
from imagecaptioning_tpu.ops.rnn import LSTM as JaxLSTM
from imagecaptioning_tpu.utils.torch_port import export_reference_gt_model
from imagecaptioning_tpu_torch.data import proposals as port_proposals
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
from imagecaptioning_tpu_torch.models.backbones import vgg as port_vgg
from imagecaptioning_tpu_torch.models.heads import LanguageHead
from imagecaptioning_tpu_torch.ops.rnn import LSTM
from imagecaptioning_tpu_torch.utils import weights
import torch_threads  # noqa: F401  (one torch thread a test process)


def _strip(sd, prefix):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


@pytest.mark.parametrize("end_stage,final_pool", [(2, True), (5, False)])
def test_vgg_features_match_jax(end_stage, final_pool):
    rng = np.random.RandomState(end_stage)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jax_vgg.VGGFeatures(include_final_pool=final_pool,
                             end_stage=end_stage)
    v = jm.init(jax.random.PRNGKey(end_stage), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = port_vgg.VGGFeatures(include_final_pool=final_pool,
                              end_stage=end_stage).eval()
    pm.load_state_dict(_strip(
        weights.vgg_features_state_dict(v["params"]), "features"))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_vgg_classifier_matches_jax_on_chw_flatten():
    rng = np.random.RandomState(1)
    pooled = rng.randn(3, 7, 7, 8).astype(np.float32)   # (B, oh, ow, C)
    jm = jax_vgg.VGGClassifierHead()
    x_hwc = pooled.reshape(3, -1)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x_hwc))
    want = np.asarray(jm.apply(v, jnp.asarray(x_hwc)))
    pm = port_vgg.VGGClassifierHead(in_features=7 * 7 * 8).eval()
    pm.load_state_dict(_strip(
        weights.vgg_classifier_state_dict(v["params"], channels=8),
        "classifier"))
    x_chw = torch.from_numpy(pooled).permute(0, 3, 1, 2).reshape(3, -1)
    with torch.no_grad():
        got = pm(x_chw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_matches_jax(num_layers):
    rng = np.random.RandomState(num_layers)
    xs = rng.randn(3, 5, 12).astype(np.float32)
    h0 = rng.randn(num_layers, 3, 16).astype(np.float32)
    c0 = rng.randn(num_layers, 3, 16).astype(np.float32)
    jm = JaxLSTM(hidden_size=16, num_layers=num_layers)
    v = jm.init(jax.random.PRNGKey(num_layers), jnp.asarray(xs))
    pm = LSTM(12, 16, num_layers).eval()
    pm.load_state_dict(_strip(weights.lstm_state_dict(v["params"], "lstm"),
                              "lstm"))
    for state in (None, (h0, c0)):
        jstate = None if state is None else tuple(map(jnp.asarray, state))
        pstate = None if state is None else tuple(map(torch.from_numpy, state))
        ys, (h, c) = jm.apply(v, jnp.asarray(xs), jstate)
        with torch.no_grad():
            pys, (ph, pc) = pm(torch.from_numpy(xs), pstate)
        for got, want in ((pys, ys), (ph, h), (pc, c)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_lstm_dropout_only_between_layers_in_training():
    xs = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 6)
                          .astype(np.float32))
    two = LSTM(6, 8, num_layers=2, dropout=0.5)
    with torch.no_grad():
        ref, _ = two.eval()(xs)
        two.train()
        a, _ = two(xs, generator=torch.Generator().manual_seed(1))
        b, _ = two(xs, generator=torch.Generator().manual_seed(1))
        one = LSTM(6, 8, num_layers=1, dropout=0.5)
        one_eval, _ = one.eval()(xs)
        one_train, _ = one.train()(xs)
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    assert torch.equal(one_eval, one_train)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_language_head_matches_jax(num_layers):
    rng = np.random.RandomState(10 + num_layers)
    iv = rng.randn(4, 1, 20).astype(np.float32)
    toks = rng.randint(1, 27, (4, 6)).astype(np.int32)
    jm = JaxLanguageHead(vocab_size=24, embedding_size=16, rnn_size=16,
                         num_layers=num_layers, output_dropout=False)
    v = jm.init(jax.random.PRNGKey(num_layers), jnp.asarray(iv),
                jnp.asarray(toks))
    pm = LanguageHead(24, 16, 16, num_layers, image_dim=20).eval()
    pm.load_state_dict(_strip(
        weights.language_head_state_dict(v["params"], "llm"), "llm"))
    tiv, ttoks = torch.from_numpy(iv), torch.from_numpy(toks).long()

    want = jm.apply(v, jnp.asarray(iv), jnp.asarray(toks))
    jstate = jm.apply(v, jnp.asarray(iv), method=jm.init_state)
    jlogits, jstate2 = jm.apply(v, jnp.asarray(toks[:, :1]), jstate,
                                method=jm.step)
    with torch.no_grad():
        got = pm(tiv, ttoks)
        pstate = pm.init_state(tiv)
        plogits, pstate2 = pm.step(ttoks[:, :1], pstate)
    pairs = [(got, want), (plogits, jlogits)]
    pairs += list(zip(pstate, jstate)) + list(zip(pstate2, jstate2))
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def _fake_gt_params(rng):
    """A JAX GTDenseCaptioner-shaped params tree at tiny widths (2-layer
    LSTM head); only conv5_3 keeps 512 outputs, which the JAX exporter's
    fc6 reorder assumes."""
    feats, in_ch = {}, 3
    for s, chans in enumerate(jax_vgg.VGG16_STAGES):
        for i in range(len(chans)):
            out = 512 if (s, i) == (4, 2) else 2 + s + i
            feats[f"conv{s + 1}_{i + 1}"] = {
                "kernel": rng.randn(3, 3, in_ch, out).astype(np.float32),
                "bias": rng.randn(out).astype(np.float32)}
            in_ch = out

    def dense(i, o):
        return {"kernel": rng.randn(i, o).astype(np.float32),
                "bias": rng.randn(o).astype(np.float32)}
    lstm = {}
    for layer in range(2):
        lstm.update({f"w_ih_l{layer}": rng.randn(24, 6).astype(np.float32),
                     f"w_hh_l{layer}": rng.randn(24, 6).astype(np.float32),
                     f"b_ih_l{layer}": rng.randn(24).astype(np.float32),
                     f"b_hh_l{layer}": rng.randn(24).astype(np.float32)})
    return {"features": feats,
            "classifier": {"fc6": dense(25088, 8), "fc7": dense(8, 8)},
            "llm": {"image_encoder": dense(8, 6),
                    "lookup_table": {"embedding": rng.randn(27, 6)
                                     .astype(np.float32)},
                    "lstm": lstm, "linear": dense(6, 27)}}


def test_gt_converter_matches_jax_exporter_key_for_key():
    params = _fake_gt_params(np.random.RandomState(0))
    ref, _ = export_reference_gt_model({"params": params})
    ref = {k: v for k, v in ref.items() if not k.startswith("net.")}
    got = weights.gt_state_dict_from_jax(params)
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


def test_seeded_init_is_reproducible():
    a = weights.seeded_init_(LanguageHead(24, 16, 16), 3).state_dict()
    b = weights.seeded_init_(LanguageHead(24, 16, 16), 3).state_dict()
    c = weights.seeded_init_(LanguageHead(24, 16, 16), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm.weight_ih_l0"], c["lstm.weight_ih_l0"])
    bound = 1.0 / np.sqrt(16)
    assert float(a["lstm.bias_hh_l0"].abs().max()) <= bound


def test_config_copy_matches_jax():
    from imagecaptioning_tpu.config import dense_configs as jax_cfg
    from imagecaptioning_tpu_torch.config import dense_configs as port_cfg

    want = jax_cfg.get_gt_config().to_dict()
    got = port_cfg.get_gt_config().to_dict()
    assert sorted(got) == sorted(want)
    # only the device fields differ: the port runs on the CUDA card
    assert {k for k in got if got[k] != want[k]} == {"backend", "device"}
    for kw in ({}, {"use_lstm": True}, {"use_dropout": True,
                                         "finetune_cnn": False}):
        assert (port_cfg.name_gt_model(port_cfg.get_gt_config().replace(**kw))
                == jax_cfg.name_gt_model(jax_cfg.get_gt_config().replace(**kw)))


def test_host_helpers_match_jax():
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(u8)).numpy(),
                               np.asarray(jax_normalize(u8)),
                               rtol=1e-6, atol=1e-6)
    info = {"token_to_idx": {"a": 1, "cat": 2, "dog": 3},
            "idx_to_token": {"1": "a", "2": "cat", "3": "dog"}}
    ids = np.asarray([[4, 1, 2, 5, 3], [1, 3, 0, 2, 2], [2, 2, 2, 2, 2]])
    assert (Vocab.from_dicts_json(info).decode_sequence(ids)
            == jax_tokenizer.Vocab.from_dicts_json(info).decode_sequence(ids))
    img = rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
    np.testing.assert_array_equal(port_proposals.grid_proposer()(img),
                                  jax_proposals.grid_proposer()(img))
