"""One run of one benchmark cell: set-up, the measured window, an
optional traced stretch, the check of the window's outputs against the
plain reference, and the result line.

Everything particular to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration file, its traffic file
`portbench/workloads/<traffic>.json`, the loop the traffic names
(`portbench/loops/<loop>.py`), the limits of its checks
(`portbench/limits/<cell>.json`) and one reader a per-layer metric
(`portbench/metrics/<metric>.py`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# top-level module names that may not be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "imagecaptioning_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there: no result is printed."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Optional[Dict] = None) -> SimpleNamespace:
    """Everything `BENCHMARK.json` and the cell's files say of cell
    `name`."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    by = {w["name"]: w for w in bench["workloads"]}
    if name not in by:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(by)})")
    wl = by[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]

    def applies(metric):
        return name in metric.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and applies(m)]
    return SimpleNamespace(
        name=name, chips=wl["chips"], config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "workloads" / f"{wl['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer)


def loop_for(spec: SimpleNamespace, seed: int, device, plant=None):
    module = importlib.import_module(f"portbench.loops.{spec.traffic['loop']}")
    return module.Loop(spec.config, spec.traffic, seed, device, plant)


def reader(metric: str):
    """The `read(run)` function of `portbench/metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(f"portbench_metric_{metric}",
                                               path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module.read


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def check_device(chips: int):
    """The card's name, or NoDevice when CUDA or enough cards are
    missing."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell needs "
                       f"{chips}")
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number that the cell's limits name, beside its limit."""
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"limits for numbers the loop does not read: "
                       f"{sorted(missing)}")
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", spec: Optional[SimpleNamespace] = None,
        plant: Optional[str] = None) -> Dict:
    """One run of cell `name` → the result line's object. `device` other
    than the card, `spec` (a cut configuration) and `plant` (a planted
    fault) are for the tests alone."""
    import torch

    spec = spec or cell(name)
    kind = "not measured"
    if device == "cuda":
        kind = check_device(spec.chips)
    # the host's part is launching work: a few threads keep one
    # process's load, and so its runs, steady
    torch.set_num_threads(2)
    loop = loop_for(spec, seed, device, plant)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    win = loop.window(seconds)
    marks = [("process start", t_start), *loop.phases.items()]
    print("set-up seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    print(f"window by quarters: {win.get('quarters')}", file=sys.stderr)
    result = {"correct": None, "attempted": win["attempted"],
              "failed": win["failed"]}
    values = {**win["metrics"], "setup_s": setup_s}
    breakdown = None
    busy = window_s = None
    if traced:
        tr = loop.traced(spec.traffic["profile_units"])
        run_ns = SimpleNamespace(kind=loop.kind, trace=tr,
                                 units_per_s=loop.units_per_s,
                                 flops_per_unit=loop.flops_per_unit,
                                 roi_bounds=loop.roi_bounds, device=kind)
        metrics = {}
        for m in spec.per_layer:
            v = reader(m["name"])(run_ns)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy, window_s = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {}
        for m in spec.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"the loop gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak = (torch.cuda.max_memory_allocated(0) if device == "cuda" else 0)
    loop.release()
    t_check = time.perf_counter()
    compared = checks(loop.readings()["program"], spec.limits)
    print(f"check seconds: {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    result["correct"] = (win["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in compared.values()))
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device == "cuda" else device,
                        "kind": kind, "count": spec.chips,
                        "memory_peak_bytes": peak}
    if device == "cuda":
        result["device"]["power_limit"] = power_limit()
    if traced:
        result["device"].update(busy_s=busy, window_s=window_s)
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        spec = cell(args.workload)
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_start, spec=spec)
    except NoDevice as e:
        print(f"portbench: {e}; nothing was measured", file=sys.stderr)
        return 3
    found = banned_modules()
    if found:
        print(f"portbench: modules that the run may not load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
