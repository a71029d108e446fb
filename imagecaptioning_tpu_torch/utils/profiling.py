"""Timing, tracing and NaN hooks — port of
`imagecaptioning_tpu/utils/profiling.py`.

- `StepTimer`: per-step wall times with JAX's percentile summary; given
  a `sync`, each step's time ends when the device has finished its work.
- `span(name)`: a named range of the program's own layers on the
  profiler's timeline, beside the operators and kernels it launched. It
  costs one flag read while no profiler runs, and opens a
  `torch.profiler.record_function` range while one does (`trace` below,
  the benchmark's traced stretch, or a caller's own `torch.profiler`).
- `count(name, n)`: adds to `COUNTERS`, the process's counts of what the
  host already knows (bytes copied, decode steps); always on, never a
  device sync.
- `trace(logdir)`: a `torch.profiler` context over the CPU and, where
  there is one, the CUDA card, that writes a Chrome trace file
  (`trace.json`, loadable in Perfetto or chrome://tracing) under `logdir`.
- `enable_nan_debugging()`: the reference's
  `torch.autograd.set_detect_anomaly(True)`, where JAX sets
  `jax_debug_nans`: a backward that makes a NaN raises, before the
  optimizer's update.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# what the program counts, by name: see `count`
COUNTERS: collections.Counter = collections.Counter()


class _NoSpan:
    """The span while no profiler runs: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context naming a layer of the program on the profiler's timeline.
    While no profiler is active it is one shared no-op (a read of the flag
    that torch's profiler sets when it starts); while one is, a
    `record_function(name)` range, nested in the spans open on the
    thread. Names are dotted (`dense.step`, `rpn.sampler`) and never
    start with torch's own prefixes (`aten::`, `Optimizer.step#`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to `COUNTERS[name]`. For numbers the host knows without
    asking the device."""
    COUNTERS[name] += n


def _waiter(sync) -> Optional[Callable[[], None]]:
    """`sync` (None, a device or its name, or a callable) → what waits for
    the device's work, or None."""
    if sync is None or callable(sync):
        return sync
    dev = torch.device(sync)
    if dev.type != "cuda":
        return None
    return lambda: torch.cuda.synchronize(dev)


class StepTimer:
    """Accumulates per-step wall times (ms); use as a context per step.
    With `sync` (a device, or a callable that waits for one), the clock
    is read on exit only after the device has finished the step's work,
    so a time is the step's and not its enqueue's."""

    def __init__(self, sync: Union[None, str, torch.device,
                                   Callable[[], None]] = None):
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None
        self._sync = _waiter(sync)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
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
