"""The PyTorch port's GT-box dense-caption serving slice against the JAX
package, end to end at a tiny size.

One JAX `GTDenseCaptioner` init (2 VGG stages, 32×32 images, LSTM head
16 wide, vocab 24, seq 5) is carried over with the port's converter and
both sides run on the same numpy inputs, fp32:
- teacher-forced logits and region codes: atol 1e-4 (VGG and the
  4096-wide classifier summed in another order);
- greedy region tokens: identical;
- beam-3 region tokens and finished flags: identical; scores: rtol and
  atol 1e-5 (log-softmax sums in another order).
Also: the port's infer CLI against the JAX CLI on two tiny PNGs, with
either head (the transformer at its default width, E=256, 3 + 3 layers,
4 heads, from a reference-layout checkpoint with the encoder's dead word
embedding and full position table), the raise when CUDA is absent, and
that the port imports nothing of JAX.
"""

import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imagecaptioning_tpu.data.vg_loader import normalize_images as jax_normalize
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.models.densecap import GTDenseCaptioner as JaxGT
from imagecaptioning_tpu_torch import infer as port_infer
from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.weights import gt_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=24, seq_length=5, embedding_size=16, rnn_size=16,
          vgg_stages=2)
STEPS = KW["seq_length"] + 1


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model, images, boxes, labels)."""
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    boxes = np.stack([rng.uniform(4, 28, (2, 4)), rng.uniform(4, 28, (2, 4)),
                      rng.uniform(4, 24, (2, 4)), rng.uniform(4, 24, (2, 4))],
                     axis=-1).astype(np.float32)
    boxes[1, 3] = 1.0                      # a degenerate pad box
    labels = rng.randint(1, 25, (2, 4, 5)).astype(np.int32)
    jm = JaxGT(use_lstm=True, **KW)
    images = np.array(jax_normalize(u8))
    k = jax.random.PRNGKey(0)
    v = jm.init({"params": k, "sampling": k}, jnp.asarray(images),
                jnp.asarray(boxes), jnp.asarray(labels), train=False)
    pm = GTDenseCaptioner(**KW).eval()
    pm.load_state_dict(gt_state_dict_from_jax(
        jax.tree.map(np.asarray, v["params"])))
    port_images = normalize_images(torch.from_numpy(u8))
    np.testing.assert_allclose(port_images.numpy(), images, atol=1e-6)
    return jm, v, pm, images, boxes, labels


def test_teacher_forced_logits_match_jax(pair):
    jm, v, pm, images, boxes, labels = pair
    want = jm.apply(v, jnp.asarray(images), jnp.asarray(boxes),
                    jnp.asarray(labels), train=False)
    with torch.inference_mode():
        got = pm(torch.from_numpy(images), torch.from_numpy(boxes),
                 torch.from_numpy(labels).long())
    assert got.logits.shape == (2, 4, 6, 27)
    np.testing.assert_allclose(got.region_codes.numpy(),
                               np.asarray(want.region_codes),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-4, atol=1e-4)


def test_greedy_region_decode_matches_jax(pair):
    jm, v, pm, images, boxes, _ = pair
    want = jax_api.make_region_greedy_fn(jm, STEPS)(
        v, jnp.asarray(images), jnp.asarray(boxes))
    got = api.make_region_greedy_fn(pm, STEPS)(torch.from_numpy(images),
                                               torch.from_numpy(boxes))
    assert got.shape == (8, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam3_region_decode_matches_jax(pair):
    jm, v, pm, images, boxes, _ = pair
    want = jax_api.make_region_beam_fn(jm, STEPS, 3)(
        v, jnp.asarray(images), jnp.asarray(boxes))
    got = api.make_region_beam_fn(pm, STEPS, 3)(torch.from_numpy(images),
                                               torch.from_numpy(boxes))
    assert got.tokens.shape == (8, 3, STEPS)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.finished.numpy(),
                                  np.asarray(want.finished))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def transformer_pair(pair):
    """(jax model, jax variables, port model): the GT transformer head at
    its default width over the same 2-stage trunk."""
    _, _, _, images, boxes, labels = pair
    kw = {k: KW[k] for k in ("vocab_size", "seq_length", "vgg_stages")}
    jm = JaxGT(use_lstm=False, **kw)
    k = jax.random.PRNGKey(1)
    v = jax.jit(jm.init)({"params": k, "sampling": k}, jnp.asarray(images),
                         jnp.asarray(boxes), jnp.asarray(labels))
    pm = GTDenseCaptioner(use_lstm=False, **kw).eval()
    pm.load_state_dict(gt_state_dict_from_jax(
        jax.tree.map(np.asarray, v["params"])))
    return jm, v, pm


@pytest.mark.parametrize("use_lstm", [True, False])
def test_infer_cli_matches_jax_cli(pair, transformer_pair, tmp_path,
                                   use_lstm):
    import infer as jax_infer
    from imagecaptioning_tpu.utils.checkpoint import save_checkpoint

    jm, v, pm = pair[:3] if use_lstm else transformer_pair
    # the reference layout, with its duplicate net.* registrations (and
    # the transformer encoder's dead word embedding and full position
    # table, which the port's loader drops)
    sd = dict(pm.state_dict())
    for k in list(sd):
        if k.startswith("features."):
            sd["net.vgg16_backbone." + k[len("features."):]] = sd[k]
        elif k.startswith("classifier."):
            sd["net.full_conv." + k[len("classifier."):]] = sd[k]
    if not use_lstm:
        sd["llm.encoder.word_embedding.weight"] = torch.zeros_like(
            sd["llm.decoder.word_embedding.weight"])
        pos = torch.zeros_like(sd["llm.decoder.position_embedding.weight"])
        pos[:1] = sd["llm.encoder.position_embedding.weight"]
        sd["llm.encoder.position_embedding.weight"] = pos
    torch.save(sd, str(tmp_path / "gt.pth"))
    save_checkpoint(str(tmp_path / "gt.ckpt"),
                    {"params": jax.tree.map(np.asarray, v["params"])})
    words = ["a", "cat", "dog", "man", "red", "on", "the", "tree"]
    words += [f"w{i}" for i in range(16)]
    dicts = {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
             "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}
    (tmp_path / "dicts.json").write_text(json.dumps(dicts))
    imdir = tmp_path / "photos"
    imdir.mkdir()
    rng = np.random.RandomState(1)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (120, 160, 3), dtype=np.uint8)
                        ).save(str(imdir / f"d{i}.png"))
    head = (["input_encoding_size=16", "rnn_size=16", "use_lstm=true"]
            if use_lstm else [])       # the transformer: the default config
    common = ["--model-type", "gt", "--dicts", str(tmp_path / "dicts.json"),
              "--images", str(imdir), "--seq-length", "5",
              "--max-regions", "4", "--set", "vgg_stages=2",
              "compute_dtype=float32", *head]
    got = port_infer.main(common + ["--ckpt", str(tmp_path / "gt.pth"),
                                    "--device", "cpu",
                                    "--out", str(tmp_path / "caps.json")])
    want = jax_infer.main(common + ["--ckpt", str(tmp_path / "gt.ckpt")])
    assert sorted(got) == ["d0.png", "d1.png"]
    assert got == want
    assert json.loads((tmp_path / "caps.json").read_text()) == got


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_infer.main(["--model-type", "gt", "--ckpt", "x.pth",
                         "--dicts", "x.json", "--images", "."])
    for model_type in ("lstm", "lstm_attention", "transformer", "vitb"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_infer.main(["--model-type", model_type, "--ckpt", "x.pth",
                             "--dicts", "x.json", "--images", "."])


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "imagecaptioning_tpu"}


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "imagecaptioning_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    port = REPO / "imagecaptioning_tpu_torch"
    for name in ("models/backbones/vit.py", "utils/pretrained.py",
                 "train_LSTMwAttention.py", "train_Transformer.py",
                 "train_ViTB.py", "models/captioners.py", "models/heads.py",
                 "utils/tb.py", "utils/profiling.py",
                 "train/optim_updates.py", "data/synthetic.py",
                 "eval/porter.py", "eval/meteor.py", "eval/bleu.py",
                 "utils/visualize.py", "evidence_run.py",
                 "tools/smoke_timings.py", "utils/torch_port.py",
                 "convert_checkpoint.py", "data/preprocess_vg.py",
                 "data/preprocess_face2text.py", "data/fixups.py",
                 "preprocess.py", "preprocess_face2text.py"):
        assert port / name in files, name
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (
                    f"{os.path.relpath(path, REPO)} imports {name}")
