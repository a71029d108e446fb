"""The cells `gt-kimivl-serve-b8` and `gt-lstm-train-b4` at a size the CPU
holds: a run of each loop is correct, each fault the cell can have comes
out not correct, and the configuration file holds every number of the
published config it names."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, lm_flops, moe_bounds

ROOT = Path(__file__).resolve().parents[2]
SERVE, TRAIN = "gt-kimivl-serve-b8", "gt-lstm-train-b4"

# Kimi-VL-A3B-Instruct's config.json, its language model's keys
# (huggingface.co/moonshotai/Kimi-VL-A3B-Instruct)
PUBLISHED = {
    "vocab_size": 163840, "max_position_embeddings": 131072,
    "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64,
    "ep_size": 1, "routed_scaling_factor": 2.446, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "qk_nope_head_dim": 128, "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "num_experts_per_tok": 6, "moe_layer_freq": 1,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16,
    "hidden_act": "silu", "rms_norm_eps": 1e-05, "rope_theta": 800000,
    "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False}


def tiny(cell):
    spec = harness.cell(cell)
    if cell == SERVE:
        spec.config.update(
            vgg_stages=2, vocab_size=211, hidden_size=64,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
            qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=24,
            num_hidden_layers=4, n_routed_experts=16, prompt_length=3,
            compute_dtype="float32", param_dtype="float32")
        # the limits are set for bf16 at the published widths; in float32
        # at this size a sound run reads float32 rounding (under 1e-4)
        # and every planted fault above 1e-2
        spec.limits = dict.fromkeys(spec.limits, 1e-3)
        spec.traffic.update(images=2, image_side=16, boxes=3, pool=2,
                            box_side=[4, 12], decode_steps=4, checked=2,
                            warmup=1, profile_units=1)
    else:
        spec.config.update(vgg_stages=3, rnn_size=32, input_encoding_size=32,
                           vocab_size=50, seq_length=6)
        spec.traffic.update(images=2, image_side=64, boxes=4, pool=3,
                            box_side=[8, 40], caption_length=[2, 6],
                            profile_units=1)
        # the limits are set at the published widths on the card; bf16 on
        # the CPU at this size reads up to 6e-4 (the change's median) and
        # a half batch 5e-3 and above on every number
        spec.limits = dict.fromkeys(spec.limits, 3e-3)
    return spec


def run(cell, plant=None):
    return harness.run(cell, 2147483921, 0.3, plant is None,
                       time.perf_counter(), device="cpu", spec=tiny(cell),
                       plant=plant)


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell,plant", [
    (SERVE, p) for p in ("token", "half_batch", "top5", "no_shared",
                         "no_bias", "other_prefix")] + [(TRAIN, "half_batch")])
def test_a_planted_fault_is_not_correct(cell, plant):
    assert run(cell, plant)["correct"] is False


def test_the_configuration_is_the_published_one():
    conf = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())
                ["configs"] if c["name"] == "gt-vgg16-kimivl-a3b")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["source"] == conf["source"]
    assert {k: cfg[k] for k in PUBLISHED} == PUBLISHED
    assert cfg["reduced"] == conf["reduced"] == ["vision_config"]


def test_the_serving_cells_counts():
    spec = harness.cell(SERVE)
    # 8 x 121 image tokens, 256 x 17 prefill tokens, 256 x 19 decoded,
    # each through 26 MoE layers at 6 experts a token
    assert moe_bounds.expected_assignments(spec.config, spec.traffic) == \
        26 * 6 * (968 + 4352 + 4864)
    call = lm_flops.region_lm_call(spec.config, spec.traffic)
    assert 4.5e13 < call["total"] < 6.5e13


def test_a_run_of_the_serving_cell_loads_no_jax():
    # `test_portbench_run.py` cuts the LSTM cells' widths only; this cell
    # is cut to its own small size here
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from portbench.tests import test_portbench_region_lm as t
t.run({SERVE!r})
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "imagecaptioning_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "imagecaptioning_tpu"}
