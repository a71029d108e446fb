"""The frozen yardstick: the analytic operation counts, the ROI kernels'
bounds, the traffic generator, the seeded weights and the trace reader."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness, roi_bounds, trace, traffic, weights
from portbench.reference import densecap_rpn, gt_lstm
from portbench.reference import layers as L


def test_vgg16_by_hand():
    # the 13 convolutions at 720^2: 317.1 GFLOP an image
    by_hand = 2 * 9 * (720 ** 2 * (3 * 64 + 64 * 64)
                       + 360 ** 2 * (64 * 128 + 128 * 128)
                       + 180 ** 2 * (128 * 256 + 2 * 256 * 256)
                       + 90 ** 2 * (256 * 512 + 2 * 512 * 512)
                       + 45 ** 2 * 3 * 512 * 512)
    assert sum(f for _, f in flops.vgg16(720, 5)) == by_hand
    assert abs(by_hand / 1e9 - 317.1) < 0.1


def test_cells_totals():
    spec = harness.cell("rpn-train-b4")
    step = flops.rpn_train_step(spec.config, spec.traffic)
    assert 4.0e12 < step["total"] < 4.3e12
    spec = harness.cell("gt-lstm-serve-b8")
    call = flops.gt_greedy_call(spec.config, spec.traffic)
    assert 2.6e12 < call["total"] < 2.7e12


def _tiny(cfg):
    return {**cfg, "vgg_stages": 3, "rnn_size": 16, "input_encoding_size": 16,
            "vocab_size": 20, "seq_length": 4, "sampler_batch_size": 8,
            "fc": 64}


def test_rpn_step_counts_against_the_flop_counter():
    spec = harness.cell("rpn-train-b4")
    cfg = _tiny(spec.config)
    tr = {**spec.traffic, "images": 2, "image_side": 32, "boxes": 3}
    w = weights.make(densecap_rpn.param_layout(cfg), 3, "cpu")
    batch = traffic.pool({**tr, "pool": 1}, cfg, 3)[0]
    kind = densecap_rpn.groups(cfg, w)
    for k, v in w.items():
        v.requires_grad_(kind[k] != "frozen")
    a = (32 // 8) ** 2 * 12
    keys = (torch.rand(2, a), torch.rand(2, a))
    mask = torch.ones(2, cfg["sampler_batch_size"], cfg["fc"])
    with FlopCounterMode(display=False) as counter:
        total = densecap_rpn.losses(
            w, cfg, torch.from_numpy(batch["image"]),
            torch.from_numpy(batch["boxes"]),
            torch.from_numpy(batch["box_mask"]),
            torch.from_numpy(batch["labels"]).long(), keys, mask)["total"]
        total.backward()
    counts = counter.get_flop_counts()["Global"]
    # the one batched product is the backward of the ROI pooling's affine
    # grid (the boxes' gradient), which the model's count leaves out
    products = sum(v for k, v in counts.items() if str(k) != "aten.bmm")
    assert products == flops.rpn_train_step(cfg, tr)["total"]


def test_gt_call_counts_against_the_flop_counter():
    spec = harness.cell("gt-lstm-serve-b8")
    cfg = _tiny(spec.config)
    tr = {**spec.traffic, "images": 2, "image_side": 32, "boxes": 3,
          "decode_steps": 5}
    w = weights.make(gt_lstm.param_layout(cfg), 3, "cpu")
    batch = traffic.pool({**tr, "pool": 1}, cfg, 3)[0]
    toks = torch.randint(1, 20, (6, 5))
    with FlopCounterMode(display=False) as counter:
        gt_lstm.logits(w, cfg, torch.from_numpy(batch["image"]),
                       torch.from_numpy(batch["boxes"]), toks)
    assert counter.get_total_flops() == flops.gt_greedy_call(cfg, tr)["total"]


def test_roi_bounds_of_the_perf_record():
    # kernels A and B at the RPN training shape (4 x 45 x 45 x 512 bf16,
    # 256 sampled boxes); K1 at the 512^2 GT serving shape (8 x 16 x 16)
    train = roi_bounds.per_launch("train", 4, 256, 45, 45, 512, 2)
    assert round(train["A"], 4) == 0.0178 and round(train["B"], 4) == 0.0178
    serve = roi_bounds.per_launch("serve", 8, 32, 16, 16, 512, 2)
    assert round(serve["K1"], 5) == 0.00446 and set(serve) == {"K1"}


def test_traffic_is_seeded_and_keeps_its_sizes():
    spec = harness.cell("rpn-train-b4")
    tr = {**spec.traffic, "image_side": 64, "box_side": [8, 40], "pool": 2}
    a, b = traffic.pool(tr, spec.config, 5), traffic.pool(tr, spec.config, 5)
    c = traffic.pool(tr, spec.config, 2 ** 31 + 7)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["image"], c[0]["image"])

    def sizes(p):
        return sorted(np.concatenate([q["boxes"][..., 2:].ravel() for q in p]))

    def lengths(p):
        return sorted(np.concatenate([(q["labels"] > 0).sum(-1).ravel()
                                      for q in p]))
    assert sizes(a) == sizes(c) and lengths(a) == lengths(c)
    corners = np.concatenate([q["boxes"] for q in c]).reshape(-1, 4)
    lo = corners[:, :2] - (corners[:, 2:] - 1) / 2
    hi = corners[:, :2] + (corners[:, 2:] - 1) / 2
    assert (lo >= 1).all() and (hi <= 64).all()


def test_weights_are_seeded_and_rounded_where_served_narrow():
    spec = harness.cell("gt-lstm-serve-b8")
    cfg = _tiny(spec.config)
    layout = gt_lstm.param_layout(cfg)
    a = weights.make(layout, 9, "cpu", gt_lstm.narrow_params(cfg),
                     torch.bfloat16)
    b = weights.make(layout, 9, "cpu")
    for k in a:
        if k.startswith(gt_lstm.narrow_params(cfg)):
            assert torch.equal(a[k], b[k].bfloat16().float())
        else:
            assert torch.equal(a[k], b[k])
    other = weights.make(layout, 10, "cpu")
    assert not torch.equal(other["llm.rnn.linear.weight"],
                           b["llm.rnn.linear.weight"])
    with pytest.raises(KeyError):
        weights.load_into(torch.nn.Linear(2, 2), b)


class _Event:
    def __init__(self, name, dev, start, dur, corr, tid, kind):
        self._v = (name, dev, start, dur, corr, tid, kind)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def start_thread_id(self): return self._v[5]


class _Typed(_Event):
    def activity_type(self): return self._v[6]


class _Prof:
    def __init__(self, events):
        class R:
            def events(self_):
                return events
        self.profiler = type("P", (), {"kineto_results": R()})()


@pytest.mark.parametrize("cls", [_Event, _Typed])
def test_trace_reader(cls):
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    dev_events = [
        cls("cudaLaunchKernel", cpu, 100, 5, 1, 7, "cuda_runtime"),
        cls("k_conv", gpu, 1000, 400, 1, 0, "kernel"),
        cls("cudaLaunchKernel", cpu, 200, 5, 2, 7, "cuda_runtime"),
        cls("k_roi_align_kernel", gpu, 1600, 100, 2, 0, "kernel"),
        cls("Memcpy HtoD (Pageable -> Device)", gpu, 1800, 200, 3, 0,
            "gpu_memcpy"),
    ]
    host_events = [
        cls(trace.WINDOW, cpu, 0, 10_000_000, 10, 7, "user_annotation"),
        cls(trace.WINDOW, gpu, 0, 10_000_000, 10, 0, "gpu_user_annotation"),
        cls("aten::_convolution", cpu, 50, 100, 11, 7, "cpu_op"),
        cls("cudaLaunchKernel", cpu, 100, 5, 1, 7, "cuda_runtime"),
        cls("k_conv", gpu, 1000, 400, 1, 0, "kernel"),
        cls("aten::mm", cpu, 4_000_000, 2_000_000, 12, 8, "cpu_op"),
    ]
    tr = trace.Trace(_Prof(dev_events), _Prof(host_events), units=2)
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_s == pytest.approx(700e-9)
    assert tr.launches() == 2
    assert tr.kernels(["roi_align_kernel"]) == (1, pytest.approx(100e-9))
    assert tr.under(["aten::_conv"]) == pytest.approx(400e-9)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::mm"] == pytest.approx((10_000_000 - 1400) / 1e9)
    assert tr.top_device_ops()[0][0] == "k_conv"


def test_fp8_control_rounds_both_ways():
    x = torch.linspace(-1, 1, 1001, requires_grad=True)
    y = L.fp8_round(x)
    assert 0 < (y - x).abs().max() < 0.07
    y.backward(torch.linspace(0, 1, 1001))
    assert not torch.equal(x.grad, torch.linspace(0, 1, 1001))
