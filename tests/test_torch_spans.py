"""The program's spans and counters (`utils/profiling.py`: `span`,
`count`, `COUNTERS`) and the benchmark readers that use them, on the CPU
at cut sizes:

- `span` is one shared no-op while no profiler runs (no
  `record_function` is made), and a range nested in its parent while one
  does; `count` adds up, and the data and decode paths count what they
  copy and decode;
- a traced stretch of each benchmark cell's loop (`portbench/loops/`,
  as `harness.run` traces it) holds every span on that cell's path, its
  host-span readers read a positive number and its device-ms readers
  nothing (there are no device events on the CPU);
- the GT training step holds its spans, torch's optimizer range inside
  `dense.update`;
- `Trace.idle_gaps` names the idle gaps by the span the host was in.
"""

import contextlib
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagecaptioning_tpu_torch.config import dense_configs
from imagecaptioning_tpu_torch.models import decoding
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import harness  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402

# the spans on each cell's path, and the readers that read host spans
# (a positive number on the CPU) or device time under one (None there)
CELLS = {
    "rpn-train-b4": {
        "spans": ("dense.to_device", "data.normalize", "dense.step",
                  "rpn.trunk", "rpn.head", "rpn.sampler", "rpn.roi_heads",
                  "rpn.caption", "dense.backward", "dense.update"),
        "host": ("sampler_host_ms.train", "step_host_ms.train"),
        "device": ("h2d_gbps.train",)},
    "gt-lstm-serve-b8": {
        "spans": ("data.normalize", "gt.greedy", "gt.encode", "gt.trunk",
                  "gt.roi", "gt.classifier", "decode.greedy"),
        "host": (),
        "device": ("encode_ms.serve", "decode_step_ms.serve")},
}


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, {e.name for e in prof.events()}


# ------------------------------------------------------------- the facility

def test_span_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("dense.step"), profiling.span("rpn.sampler")
    assert a is b                         # one shared object, no allocation
    with a, b:
        torch.ones(2).sum()
    assert opened == []

    def spanned():
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("dense.step"):
            with profiling.span("rpn.sampler"):
                torch.ones(4).sum()
    prof, names = _profiled_names(spanned)
    assert opened == ["dense.step", "rpn.sampler"]
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in prof.events()}
    assert parent["rpn.sampler"] == "dense.step"
    assert parent["aten::sum"] == "rpn.sampler"
    assert not torch.autograd.profiler._is_profiler_enabled


def test_count_adds_up_and_the_paths_count():
    c = profiling.COUNTERS
    before = c["test.things"]
    profiling.count("test.things")
    profiling.count("test.things", 41)
    assert c["test.things"] - before == 42

    batch = {"image": np.zeros((4, 8, 8, 3), np.uint8),
             "boxes": np.zeros((4, 3, 4), np.float32),
             "labels": np.zeros((4, 3, 5), np.int32),
             "box_mask": np.ones((4, 3), np.float32)}
    b0, n0 = c["to_device.batches"], c["to_device.bytes"]
    dense_driver.to_device(batch, torch.device("cpu"), slice(1, 3))
    assert c["to_device.batches"] - b0 == 1
    assert c["to_device.bytes"] - n0 == sum(a[1:3].nbytes
                                            for a in batch.values())

    def step(carry, toks, t):
        return carry, torch.zeros(toks.shape[0], 7)
    calls, steps = c["decode.calls"], c["decode.steps"]
    decoding.greedy_decode(step, torch.zeros(3, 2), 3, 1, 6)
    assert (c["decode.calls"] - calls, c["decode.steps"] - steps) == (1, 6)


# ------------------------------------------------------ the cells' paths

@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cells_traced_stretch_holds_its_spans(cell):
    spec = harness.cell(cell)
    spec.config.update(vgg_stages=2, rnn_size=16, input_encoding_size=16,
                       vocab_size=20, seq_length=4)
    if "sampler_batch_size" in spec.config:
        spec.config["sampler_batch_size"] = 8
        spec.traffic.update(caption_length=[2, 4])
    else:
        spec.traffic.update(decode_steps=5)
    spec.traffic.update(images=2, image_side=32, boxes=3, pool=3,
                        box_side=[8, 24], checked=1, warmup=1,
                        profile_units=1)
    threads = torch.get_num_threads()
    try:
        loop = harness.loop_for(spec, 2147483901, "cpu")
        loop.setup()
        tr = loop.traced(spec.traffic["profile_units"])
    finally:
        torch.set_num_threads(threads)
    names = {n for ranges in tr.host.host.values() for _, _, n in ranges}
    want = CELLS[cell]
    assert set(want["spans"]) <= names, set(want["spans"]) - names
    run = SimpleNamespace(kind=loop.kind, trace=tr, units_per_s=None,
                          flops_per_unit=loop.flops_per_unit,
                          roi_bounds=loop.roi_bounds, device="cpu")
    listed = {m["name"] for m in spec.per_layer}
    assert set(want["host"]) | set(want["device"]) <= listed
    for name in want["host"]:
        assert harness.reader(name)(run) > 0, name
    for name in want["device"]:
        assert harness.reader(name)(run) is None, name


def test_the_gt_training_step_holds_its_spans():
    cfg = dense_configs.get_gt_config().replace(
        use_lstm=True, input_encoding_size=16, rnn_size=16, vgg_stages=2,
        compute_dtype="float32")
    dev = torch.device("cpu")
    model = dense_driver.build_gt_model(cfg, 20, 4, dev)
    optimizer = dense_driver.make_dense_optimizer(cfg, model, 0)
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    step = dense_driver.make_gt_train_step(model, optimizer, False, gen)
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8),
             "boxes": np.tile(np.float32([16, 16, 12, 12]), (2, 3, 1)),
             "labels": rng.integers(1, 20, (2, 3, 4), dtype=np.int32),
             "box_mask": np.ones((2, 3), np.float32)}
    images, boxes, labels, mask = dense_driver.to_device(batch, dev)
    prof, names = _profiled_names(
        lambda: step(images, boxes, labels, mask, 1.0))
    assert {"dense.step", "data.normalize", "gt.trunk", "gt.roi",
            "gt.classifier", "dense.backward", "dense.update"} <= names
    adam = [e for e in prof.events()
            if e.name.startswith("Optimizer.step#DenseAdam.step")]
    assert adam and all(e.cpu_parent.name == "dense.update" for e in adam)


# ----------------------------------------------------------- idle gaps

def _unit(spanned: bool):
    """A step whose host runs Python between operators: 3 ms inside
    `dense.step` alone and 3 ms inside `rpn.sampler` (with spans)."""
    open_span = (profiling.span if spanned
                 else lambda name: contextlib.nullcontext())
    with open_span("dense.step"):
        x = torch.ones(32, 32) @ torch.ones(32, 32)
        time.sleep(0.003)
        x = x + 1
        with open_span("rpn.sampler"):
            time.sleep(0.003)
            x.sum()


@pytest.mark.parametrize("spanned", [True, False])
def test_idle_gaps_carry_the_program_span_names(spanned):
    tr = bench_trace.record(lambda: _unit(spanned), 3, lambda: None)
    s = tr.host
    # the device works while the host is inside an operator, and waits
    # while the host runs Python
    ops = [(a, b) for ranges in s.host.values() for a, b, name in ranges
           if name.startswith("aten::")]
    s.device = [("kernel", "k", a, b - a) for a, b in ops]
    s.launch = [None] * len(s.device)
    gaps = dict(tr.idle_gaps())
    unnamed = gaps.get("(no host range)", 0.0)
    if spanned:
        assert gaps.get("dense.step", 0) >= 3 * 0.0027, gaps
        assert gaps.get("rpn.sampler", 0) >= 3 * 0.0027, gaps
        assert unnamed < 0.1 * (gaps["dense.step"] + gaps["rpn.sampler"])
    else:
        assert unnamed >= 3 * 0.0054, gaps
        assert "dense.step" not in gaps and "rpn.sampler" not in gaps
