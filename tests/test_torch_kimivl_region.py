"""The region language model (`models/moe_lm.py`, `ops/moe.py`,
`densecap.GTRegionLMCaptioner`) against its plain float32 reference
(`tests/plain_kimivl_region.py`), on the CPU at a small size with seeded
weights: hidden 64, 4 heads, latent 32, RoPE 16, no-RoPE 16, values 16,
one dense layer and three MoE layers of 16 experts (top 6, 2 shared),
a vocabulary of 211, a 4 x 4 map merged into 4 image tokens, 2 images x 3
boxes, a 3-token prompt and 4 decoded tokens. Both sides run in float32,
so every tolerance below is float32 rounding of sums taken in another
order (the absorbed decode, the grouped experts, batched attention).
"""

import inspect
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import plain_kimivl_region as plain  # noqa: E402
import torch_threads  # noqa: E402,F401  (one torch thread a test process)
from imagecaptioning_tpu_torch.data.vg_loader import \
    normalize_images  # noqa: E402
from imagecaptioning_tpu_torch.models import api, moe_lm  # noqa: E402
from imagecaptioning_tpu_torch.ops import moe as moe_ops  # noqa: E402
from imagecaptioning_tpu_torch.train import dense_driver  # noqa: E402
from imagecaptioning_tpu_torch.utils.profiling import COUNTERS  # noqa: E402
from portbench import harness, moe_bounds, program  # noqa: E402
from portbench.reference import kimivl_region as bench_ref  # noqa: E402
from portbench.reference.layers import EXACT  # noqa: E402

CELL = "gt-kimivl-serve-b8"
SMALL = dict(vgg_stages=2, vocab_size=211, hidden_size=64,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
             intermediate_size=96, moe_intermediate_size=24,
             num_hidden_layers=4, n_routed_experts=16, prompt_length=3,
             compute_dtype="float32", param_dtype="float32")
SMALL_TRAFFIC = dict(images=2, image_side=16, boxes=3, pool=2,
                     box_side=[4, 12], decode_steps=4, checked=2, warmup=1,
                     profile_units=1)
STEPS = 4
# float32 on both sides: sums in other orders differ by a few ulps of
# the largest terms; 1e-4 of the logits' scale is two orders above that
# and two below the smallest gap a fault makes
TOL = 1e-4


def _spec():
    spec = harness.cell(CELL)
    spec.config.update(SMALL)
    spec.traffic.update(SMALL_TRAFFIC)
    return spec


@pytest.fixture(scope="module")
def small():
    cfg = _spec().config
    w = dict(bench_ref.make_weights(cfg, 11, "cpu"))
    model = dense_driver.build_gt_model(program.dense_config(cfg), 0, 0,
                                        torch.device("cpu")).eval()
    program.weights.load_into(model, w)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg["vocab_size"], 3))
    model.lm.prompt_ids.copy_(prompt)
    images = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3),
                                           dtype=np.uint8))
    boxes = torch.tensor([[[5.0, 6.0, 6.0, 8.0], [10.0, 9.0, 10.0, 12.0],
                           [8.5, 8.5, 15.0, 15.0]]] * 2)
    boxes[1] = boxes[1].flip(0)
    return SimpleNamespace(cfg=cfg, w=w, model=model, prompt=prompt,
                           images=images, boxes=boxes)


@torch.inference_mode()
def _decode(model, images, boxes, absorbed=True):
    """The program's greedy decode by hand: tokens (B, STEPS) and the
    logits (B, STEPS, V) that chose them."""
    enc = model.encode_flat(normalize_images(images), boxes)
    carry, _ = model.init_decode(enc, max_steps=STEPS)
    logits = [carry.first_logits]
    toks = [logits[0].argmax(-1, keepdim=True)]
    start = 1 + model.lm.s.prompt_length
    for t in range(1, STEPS):
        logits.append(model.lm.decode_step(carry, toks[-1], start + t - 1,
                                           absorbed))
        toks.append(logits[-1].argmax(-1, keepdim=True))
    return torch.cat(toks, 1), torch.stack(logits, 1)


def _close(got, want, tol=TOL):
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= tol * float(scale), (
        float((got - want).abs().max()), float(scale))


def test_prefill_and_cached_decode_match_the_full_forward(small):
    toks, logits = _decode(small.model, small.images, small.boxes)
    want = bench_ref.logits(small.w, small.cfg, small.images, small.boxes,
                            small.prompt, toks)
    _close(logits, want)
    # the served path: make_region_greedy_fn's tokens are the argmax of
    # the same logits (first token from the prefill)
    served = api.make_region_greedy_fn(small.model, STEPS)(
        normalize_images(small.images), small.boxes)
    assert torch.equal(served, toks)
    assert torch.equal(want.argmax(-1), toks)


def test_the_moe_layer_alone_and_its_choice(small):
    layer = small.model.lm.layers[2].mlp
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(2))
    p = "lm.layers.2.mlp."
    with torch.no_grad():
        w, idx = layer.route(x)
        got = layer(x, w, idx)
    want_idx, _ = plain.route(x, small.w, p, small.cfg)
    assert torch.equal(idx.sort(-1).values, want_idx.sort(-1).values)
    _close(got, plain.moe(x, small.w, p, small.cfg, EXACT))


def test_absorbed_decode_equals_expanded(small):
    a_toks, a = _decode(small.model, small.images, small.boxes, True)
    e_toks, e = _decode(small.model, small.images, small.boxes, False)
    assert torch.equal(a_toks, e_toks)
    _close(a, e)


def test_a_regions_logits_do_not_depend_on_the_other_images(small):
    _, both = _decode(small.model, small.images, small.boxes)
    _, alone = _decode(small.model, small.images[1:], small.boxes[1:])
    _close(alone, both[3:])


def test_the_grouped_path_equals_the_per_expert_loop():
    g = torch.Generator().manual_seed(3)
    t, d, f, e, k = 30, 16, 8, 5, 2
    x = torch.randn(t, d, generator=g)
    gate_up = torch.randn(e, d, 2 * f, generator=g)
    down = torch.randn(e, f, d, generator=g)
    w, idx = moe_ops.route(torch.randn(t, e, generator=g), torch.zeros(e),
                           k, 1.5)
    got = moe_ops.experts_swiglu(x, w, idx, gate_up, down)
    want = torch.zeros(t, d)
    for i in range(t):                          # token by token
        for j in range(k):
            gg, u = (x[i] @ gate_up[idx[i, j]]).chunk(2)
            want[i] += w[i, j] * ((torch.nn.functional.silu(gg) * u)
                                  @ down[idx[i, j]])
    _close(got, want)
    # dispatch sorts by expert, and the offsets close each expert's rows
    order, offs = moe_ops.dispatch(idx, e)
    assert torch.equal(idx.reshape(-1)[order],
                       idx.reshape(-1)[order].sort().values)
    assert offs.tolist() == torch.bincount(idx.reshape(-1),
                                           minlength=e).cumsum(0).tolist()


def _checked(plant):
    """The benchmark's loop at the small size with `plant` -> its
    numbers."""
    loop = harness.loop_for(_spec(), 2147483911, "cpu", plant)
    loop.setup()
    loop.window(0.05)
    loop.release()
    return loop.readings()["program"]


def test_the_sound_program_reads_within_float32_rounding():
    got = _checked(None)
    assert got["logit_err_rms"] <= TOL and got["served_err_max"] <= TOL


@pytest.mark.parametrize("plant", ["token", "half_batch", "top5",
                                   "no_shared", "no_bias", "other_prefix"])
def test_a_planted_fault_fails_the_comparison(plant):
    # a planted fault moves the program's logits off the reference's by
    # far more than float32 rounding: a changed token at that token alone,
    # every other fault at the probe ids of many positions
    number = "served_err_max" if plant == "token" else "logit_err_rms"
    assert _checked(plant)[number] > 100 * TOL


def test_the_two_reference_copies_agree():
    names = [n for n, f in vars(plain).items()
             if inspect.isfunction(f) and f.__module__ == plain.__name__]
    assert len(names) >= 12
    for n in names:
        assert inspect.getsource(getattr(plain, n)) == \
            inspect.getsource(getattr(bench_ref, n)), n


def test_the_traced_stretch_holds_the_spans_and_counts(small):
    spec = _spec()
    loop = harness.loop_for(spec, 2147483901, "cpu")
    loop.setup()
    before = {k: COUNTERS[k] for k in ("moe.assignments", "lm.prefill_tokens",
                                       "lm.decode_tokens")}
    loop._call()
    per_call = {k: COUNTERS[k] - v for k, v in before.items()}
    b = 2 * 3
    assert per_call == {
        "moe.assignments": moe_bounds.expected_assignments(spec.config,
                                                           spec.traffic),
        "lm.prefill_tokens": 2 * 4 + b * (1 + 3),
        "lm.decode_tokens": b * (STEPS - 1)}
    tr = loop.traced(1)
    names = {n for ranges in tr.host.host.values() for _, _, n in ranges}
    assert {"gt.greedy", "gt.encode", "gt.project", "lm.prefill", "lm.attn",
            "lm.router", "lm.moe", "lm.head", "decode.greedy"} <= names
    # the grouped launches' bound was reckoned from the recorded routing
    assert tr.moe["layers"] == 3 * (2 + STEPS - 1)
    assert 1 <= tr.moe["experts_hit"] <= 16 and tr.moe["bound_ms"] > 0
    run = SimpleNamespace(kind="serve", trace=tr, units_per_s=None,
                          flops_per_unit=loop.flops_per_unit,
                          roi_bounds=loop.roi_bounds, device="cpu")
    for m in ("prefill_ms.serve", "moe_ms.serve", "mla_ms.serve",
              "moe_roofline.serve"):
        assert harness.reader(m)(run) is None, m     # no device on the CPU


def test_moe_bounds_at_a_stated_shape():
    # a decode step's launches at the published widths: 256 tokens x 6
    # rows over all 64 experts, bound by reading the experts' weights
    up = moe_bounds.launch_ms(1536, 2048, 2816, 64)
    down = moe_bounds.launch_ms(1536, 1408, 2048, 64)
    assert abs(up - 2 * (64 * 2048 * 2816 + 1536 * (2048 + 2816))
               / 3.35e12 * 1e3) < 1e-12
    assert abs(up - 0.224818) < 1e-6 and abs(down - 0.113348) < 1e-6
    cfg = harness.cell(CELL).config
    assert abs(moe_bounds.bound_ms(cfg, [(1536, 64)]) - (up + down)) < 1e-12
    # the regions' prefill, 4,352 tokens: bound by its operations
    assert moe_bounds.launch_ms(26112, 2048, 2816, 64) == pytest.approx(
        2 * 26112 * 2048 * 2816 / 989e12 * 1e3)


def test_the_configuration_refuses_what_it_does_not_compute():
    cfg = harness.cell(CELL).config
    assert moe_lm.LMSpec.from_config(cfg).n_routed_experts == 64
    for key, value in (("q_lora_rank", 1536), ("topk_method", "greedy"),
                       ("rope_scaling", {"type": "yarn"})):
        with pytest.raises(NotImplementedError):
            moe_lm.LMSpec.from_config({**cfg, key: value})


def test_the_full_configuration_is_not_built_on_the_cpu():
    t0 = time.perf_counter()
    loop = harness.loop_for(harness.cell(CELL), 1, "cpu")
    with pytest.raises(RuntimeError, match="on the card only"):
        loop.setup()
    assert time.perf_counter() - t0 < 5
