"""`correct` at a size the CPU holds: each fault a cell can have, planted
under a run whose look for a card is skipped, makes `correct` false; the
control (the reference in fp8 put in the program's place) reads above
the program on the numbers compared."""

import time

import pytest

from portbench import harness

TRAIN, SERVE = "rpn-train-b4", "gt-lstm-serve-b8"


def tiny(cell):
    spec = harness.cell(cell)
    spec.config.update(vgg_stages=3, rnn_size=32, input_encoding_size=32,
                       vocab_size=50, seq_length=6)
    spec.traffic.update(images=2, image_side=64, boxes=4, pool=3,
                        box_side=[8, 40], profile_units=1)
    if cell == TRAIN:
        spec.config["sampler_batch_size"] = 16
        spec.traffic["caption_length"] = [2, 6]
    else:
        spec.traffic.update(decode_steps=7, checked=2, warmup=1)
    return spec


def run(cell, plant=None):
    return harness.run(cell, 2147483921, 0.3, False, time.perf_counter(),
                       device="cpu", spec=tiny(cell), plant=plant)


@pytest.mark.parametrize("cell,plant", [(TRAIN, "half_batch"),
                                        (SERVE, "half_batch"),
                                        (SERVE, "token")])
def test_a_planted_fault_is_not_correct(cell, plant):
    assert run(cell, plant)["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from imagecaptioning_tpu_torch.train import dense_driver
    monkeypatch.setattr(dense_driver.DenseAdam, "step",
                        lambda self, closure=None: None)
    res = run(TRAIN)
    assert res["correct"] is False
    assert res["checks"]["change_step3_median"]["value"] > 0.5


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_the_control_reads_above_the_program(cell):
    spec = tiny(cell)
    loop = harness.loop_for(spec, 2147483931, "cpu")
    loop.setup()
    if loop.kind == "serve":
        loop.window(0.3)
    loop.release()
    got = loop.readings(control=True)
    assert any(got["control"][k] > 3 * got["program"][k]
               for k in spec.limits)
