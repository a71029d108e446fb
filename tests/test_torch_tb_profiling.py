"""The port's TensorBoard channel, profiling hooks and NaN debugging
(`utils/tb.py`, `utils/profiling.py`) against the JAX package's, and in
the trainers, on the CPU at tiny widths.

- `TBWriter`: a no-op without a directory; events written with one
  (port of `tests/test_tb.py`); the AlexCap and GT drivers write JAX's
  scalars (`train/…`, `val/…`) when `tensorboard_dir` is set, and an
  inactive writer, with no event file, when it is unset;
- `StepTimer.summary` equal to JAX's on the same times, and its `sync`
  waited on before the clock is read; `trace` writes a trace file, and
  the dense loop writes one of its steady steps with `profile_dir`;
  `enable_nan_debugging` as a call and as a context;
- `debug_nans` in each driver (AlexCap, GT, RPN): a NaN planted in the
  caption head's output bias stops the first step at its backward,
  before any update, the weights unchanged; without it the same run
  updates through the NaN.
"""

import glob
import os
import time

import pytest
import torch

from imagecaptioning_tpu.utils import profiling as jax_profiling
from imagecaptioning_tpu_torch.config import configs, dense_configs
from imagecaptioning_tpu_torch.train import dense_driver, driver
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils import profiling
from imagecaptioning_tpu_torch.utils.tb import TBWriter
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(autouse=True)
def _no_checkpoint_files(monkeypatch):
    """The drivers' best-model checkpoints are not written: no test here
    reads one, and a GT checkpoint with its Adam moments is ~0.5 GB."""
    monkeypatch.setattr(ckptlib, "save_checkpoint", lambda path, state: None)


# ------------------------------------------------------------- TBWriter

def test_tb_writer_is_a_noop_when_disabled():
    writer = TBWriter("")
    assert not writer.active
    writer.scalar("x", 1.0, 0)
    writer.scalars({"a": 1, "b": {"nested": 2}, "c": None}, 0)
    writer.flush()
    writer.close()


def test_tb_writer_writes_an_event_file(tmp_path):
    logdir = str(tmp_path / "tb")
    writer = TBWriter(logdir)
    if not writer.active:          # torch's TensorBoard backend is absent
        return
    writer.scalar("train/loss", 3.14, 1)
    writer.scalars({"meteor": 0.4, "breakdown": {"x": 1}, "note": "s"}, 2,
                   prefix="val/")
    writer.close()
    assert glob.glob(os.path.join(logdir, "events.out.tfevents.*"))


def _tags(logdir):
    accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    acc = accumulator.EventAccumulator(logdir)
    acc.Reload()
    return set(acc.Tags()["scalars"])


def _alexcap_cfg(tmp_path, **kw):
    return configs.get_lstm_config().replace(
        data_h5="/nonexistent", save_checkpoint_every=4, batch_size=2,
        eval_val_batch_size=2, num_epochs=1, backbone_stages=(1, 1, 1, 1),
        embedding_size=16, lstm_size=16, compute_dtype="float32",
        save_path=str(tmp_path / "m.ckpt"),
        loss_file=str(tmp_path / "l.json"),
        result_file=str(tmp_path / "r.json"), **kw)


def _gt_cfg(tmp_path, **kw):
    return dense_configs.get_gt_config().replace(
        use_lstm=True, input_encoding_size=16, rnn_size=16, vgg_stages=2,
        compute_dtype="float32", batch_size=2, max_regions=4,
        loss_log_pad=1, data_h5=str(tmp_path / "missing.h5"),
        save_path=str(tmp_path / "m.ckpt"),
        loss_file=str(tmp_path / "l.json"),
        result_file=str(tmp_path / "r.json"), **kw)


def _train(kind, cfg, max_iter_override=2, **kw):
    if kind == "alexcap":
        return driver.train(cfg, device="cpu", max_iter_override=2,
                            eval_every_override=2, synthetic_images=8,
                            verbose=False, **kw)
    run = dense_driver.train_gt if kind == "gt" else dense_driver.train_rpn
    return run(cfg, device="cpu", max_iter_override=max_iter_override,
               eval_every_override=max_iter_override, verbose=False, **kw)


@pytest.mark.parametrize("kind", ["alexcap", "gt"])
def test_driver_writes_tensorboard_only_when_asked(tmp_path, monkeypatch,
                                                   kind):
    make_cfg = _alexcap_cfg if kind == "alexcap" else _gt_cfg
    (tmp_path / "off").mkdir()
    logdir = str(tmp_path / "tb")
    if not TBWriter(logdir).active:
        return
    _train(kind, make_cfg(tmp_path, tensorboard_dir=logdir))
    tags = _tags(logdir)
    loss = "train/loss" if kind == "alexcap" else "train/captioning_loss"
    score = "val/meteor" if kind == "alexcap" else "val/map"
    assert {loss, "train/step_ms", score} <= tags, tags
    # unset: the driver's writer is the inactive one, and no event file
    # appears (torch's SummaryWriter would default to ./runs)
    built = []

    def recording(logdir):
        built.append(TBWriter(logdir))
        return built[-1]
    monkeypatch.setattr(driver if kind == "alexcap" else dense_driver,
                        "TBWriter", recording)
    monkeypatch.chdir(tmp_path / "off")
    _train(kind, make_cfg(tmp_path / "off"))
    assert len(built) == 1 and not built[0].active
    assert not glob.glob(str(tmp_path / "off" / "**" / "events.out.*"),
                         recursive=True)


# ------------------------------------------------------------ profiling

def test_step_timer_summary_matches_jax():
    times = [12.5, 3.0, 7.25, 100.0, 4.5, 4.5, 9.0]
    port, want = profiling.StepTimer(), jax_profiling.StepTimer()
    port.times_ms, want.times_ms = list(times), list(times)
    assert port.summary() == want.summary()
    assert profiling.StepTimer().summary() == {}
    timer = profiling.StepTimer()
    with timer:
        pass
    assert len(timer.times_ms) == 1 and timer.last_ms >= 0.0


def test_step_timer_waits_on_sync_before_reading_the_clock():
    waited = []

    def sync():
        time.sleep(0.02)
        waited.append(time.perf_counter())
    timer = profiling.StepTimer(sync=sync)
    with timer:
        pass
    assert len(waited) == 1 and timer.last_ms >= 20.0
    # a device: the card's synchronize, nothing to wait for on the CPU
    for dev in ("cpu", torch.device("cpu")):
        with profiling.StepTimer(sync=dev) as t:
            pass
        assert len(t.times_ms) == 1


def test_profile_dir_traces_the_steady_steps(tmp_path):
    """`profile_dir` traces the loop's steps 3 to 12: of a 4-step run, the
    fourth step alone, its spans beside its operators."""
    logdir = tmp_path / "prof"
    _train("gt", _gt_cfg(tmp_path, profile_dir=str(logdir)),
           max_iter_override=4)
    text = (logdir / "trace.json").read_text()
    assert text.count('"name": "dense.step"') == 1
    assert '"name": "gt.trunk"' in text and "aten::" in text


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "trace" / "trace.json"
    assert path.is_file() and "aten::mm" in path.read_text()


def test_enable_nan_debugging_as_call_and_context():
    assert not torch.is_anomaly_enabled()
    with profiling.enable_nan_debugging():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    profiling.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------------ debug_nans

def _plant_nan(monkeypatch, module, kept):
    """Wrap `module.seeded_init_` so that the seeded model gets a NaN in
    its caption head's output bias; keep the model and its weights."""
    seeded = module.seeded_init_

    def planted(model, seed):
        seeded(model, seed)
        with torch.no_grad():
            model.llm.rnn.linear.bias[0] = float("nan")
        kept.append((model, {k: v.clone()
                             for k, v in model.state_dict().items()}))
        return model
    monkeypatch.setattr(module, "seeded_init_", planted)


@pytest.mark.parametrize("kind", ["alexcap", "gt", "rpn"])
def test_debug_nans_stops_the_step_before_the_update(tmp_path, monkeypatch,
                                                     kind):
    if kind == "alexcap":
        cfg, module = _alexcap_cfg(tmp_path), driver
    elif kind == "gt":
        cfg, module = _gt_cfg(tmp_path), dense_driver
    else:
        cfg = dense_configs.get_densecap_config().replace(
            vgg_stages=2, input_encoding_size=16, rnn_size=16,
            compute_dtype="float32", batch_size=2, max_regions=4,
            sampler_batch_size=16, test_num_proposals=20,
            data_h5=str(tmp_path / "missing.h5"),
            save_path=str(tmp_path / "m.ckpt"),
            loss_file=str(tmp_path / "l.json"),
            result_file=str(tmp_path / "r.json"))
        module = dense_driver
    kept = []
    _plant_nan(monkeypatch, module, kept)
    with pytest.raises(RuntimeError, match="nan"):
        _train(kind, cfg.replace(debug_nans=True))
    assert not torch.is_anomaly_enabled()
    model, before = kept[0]
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, before[name], rtol=0, atol=0,
                                   equal_nan=True, msg=name)
    if kind == "gt":
        # without debug_nans the NaN flows into the update
        _train(kind, cfg.replace(
            save_path=str(tmp_path / "m2.ckpt"),
            loss_file=str(tmp_path / "l2.json"),
            result_file=str(tmp_path / "r2.json")))
        model, _ = kept[1]
        assert torch.isnan(model.llm.rnn.linear.weight).any()
