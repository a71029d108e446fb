"""The benchmark's files: BENCHMARK.json keeps to its contract's shape, and
every configuration, traffic mix, loop, limit file and per-layer reader
it names is found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.cell(cell, BENCH)
    assert spec.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m["moves"] in names
        assert callable(harness.reader(m["name"]))
    loop = harness.loop_for(spec, 1, "cpu")
    assert loop.kind in ("train", "serve")
    assert spec.limits and all(v > 0 for v in spec.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_is_silent_without_its_kind(metric):
    class Run:                          # a run of the other kind
        kind = "neither"
    assert harness.reader(metric)(Run()) is None


def test_configs_are_whole():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["vgg_stages"] == 5 and cfg["fc"] == 4096
        assert cfg["rnn_size"] == cfg["input_encoding_size"] == 512
        assert cfg["roi_size"] == [7, 7] and cfg["vocab_size"] == 10000
