"""Timing, tracing and NaN hooks — port of
`imagecaptioning_tpu/utils/profiling.py`.

- `StepTimer`: per-step host wall times with JAX's percentile summary.
- `trace(logdir)`: a `torch.profiler` context over the CPU and, where
  there is one, the CUDA card, that writes a Chrome trace file
  (`trace.json`, loadable in Perfetto or chrome://tracing) under `logdir`.
- `enable_nan_debugging()`: the reference's
  `torch.autograd.set_detect_anomaly(True)`, where JAX sets
  `jax_debug_nans`: a backward that makes a NaN raises, before the
  optimizer's update.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    """Accumulates per-step wall times (ms); use as a context per step."""

    def __init__(self):
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)
        return False

    @property
    def last_ms(self) -> float:
        return self.times_ms[-1] if self.times_ms else float("nan")

    def summary(self) -> Dict[str, float]:
        if not self.times_ms:
            return {}
        a = np.asarray(self.times_ms)
        return {"mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p90_ms": float(np.percentile(a, 90)),
                "p99_ms": float(np.percentile(a, 99)),
                "steps": int(a.size)}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A `torch.profiler` trace of the block, written to
    `<logdir>/trace.json`, when `logdir` is set; a no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True):
    """Turn autograd's anomaly mode on (or off): a backward that makes a
    NaN raises, naming the forward op. A call sets it for the process;
    used as a context manager, it puts the previous mode back on exit."""
    return torch.autograd.set_detect_anomaly(enable)
