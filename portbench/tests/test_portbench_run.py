"""How a run starts and what it loads: no result without a card or
without the package under test, no JAX in a run's process, nothing of
the program in the plain reference; on a card, a short run of each cell
(marked `cuda`, skipped without one)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
ARGS = ["--seed", "2147483901", "--seconds", "1", "--trace", "0"]


def _run(cwd, *args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, "--workload", cell, *ARGS)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_bare_benchmark_folder_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", CELLS[0], *ARGS)
    assert out.returncode != 0 and out.stdout == ""


TINY = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
spec = harness.cell({cell!r})
spec.config.update(vgg_stages=3, rnn_size=16, input_encoding_size=16,
                   vocab_size=20, seq_length=4)
if "sampler_batch_size" in spec.config:
    spec.config["sampler_batch_size"] = 8
    spec.traffic["caption_length"] = [2, 4]
else:
    spec.traffic.update(decode_steps=5, checked=1, warmup=1)
spec.traffic.update(images=2, image_side=32, boxes=3, pool=3,
                    box_side=[8, 24], profile_units=1)
harness.run({cell!r}, 5, 0.2, True, time.perf_counter(), device="cpu",
            spec=spec)
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = TINY.format(root=str(ROOT), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "imagecaptioning_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "imagecaptioning_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from portbench import compare, flops, peaks, roi_bounds, trace, traffic
from portbench import weights
from portbench.reference import densecap_rpn, gt_lstm, layers
cfg = json.load(open({str(ROOT / 'portbench/configs/gt-vgg16-lstm.json')!r}))
cfg.update(vgg_stages=3, rnn_size=16, input_encoding_size=16, vocab_size=20,
           fc=64)
w = weights.make(gt_lstm.param_layout(cfg), 1, "cpu")
gt_lstm.logits(w, cfg, torch.zeros(1, 32, 32, 3, dtype=torch.uint8),
               torch.tensor([[[16.0, 16.0, 8.0, 8.0]]]),
               torch.ones(1, 3, dtype=torch.long))
print(json.dumps(sorted(set(m.split(".")[0] for m in sys.modules))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"imagecaptioning_tpu_torch", "imagecaptioning_tpu",
                         "jax", "flax"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT, "--workload", cell, "--seed", "2147483911",
               "--seconds", "2", "--trace", "0", timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks" and res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]
