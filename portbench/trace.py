"""Reading torch.profiler (CUPTI) traces of stretches of steady work.

`record` profiles the same work twice, after one unit that starts the
profiler up:

- a stretch with the device's activity alone (kernels, copies, fills and
  the runtime calls that launched them). The host's operators are not
  recorded, so the host runs at nearly its own speed, and this stretch
  gives the device's busy time, the window (from its first device
  operation to its last), the kernels by name and the launch count;
- a stretch with the host's operators too, inside a
  `record_function(WINDOW)` range that ends after a `synchronize`. The
  profiler slows the host here, so this stretch only gives what needs the
  host's ranges: device time of the operations launched inside named
  operators, and what the host was inside during each idle gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
GAP_LABEL_MIN_NS = 20_000       # shorter idle gaps are summed unlabelled


def _kind(e, host_names) -> str:
    """The event's activity: kineto's own name where this PyTorch gives
    it, else told from the device, the name and the annotation flag."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at())
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        return ("gpu_user_annotation" if annotation or name in host_names
                else "kernel")
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Stretch:
    """One profiled stretch: its device operations (kind, name, start,
    duration) with their launches (thread, time), and the host's ranges
    (start, end, name) per thread."""

    def __init__(self, prof):
        self.device: List[Tuple[str, str, int, int]] = []
        self.launch: List[Optional[Tuple[int, int]]] = []
        launches: Dict[int, Tuple[int, int]] = {}
        host: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        self.window: Optional[Tuple[int, int, int]] = None
        corr: List[int] = []
        events = prof.profiler.kineto_results.events()
        host_names = {e.name() for e in events
                      if "CUDA" not in str(e.device_type())}
        for e in events:
            kind = _kind(e, host_names)
            if "CUDA" in str(e.device_type()):
                if kind in DEVICE_KINDS:
                    self.device.append((kind, e.name(), e.start_ns(),
                                        e.duration_ns()))
                    corr.append(e.correlation_id())
            elif kind in HOST_KINDS:
                tid, t0 = e.start_thread_id(), e.start_ns()
                host[tid].append((t0, t0 + e.duration_ns(), e.name()))
                if kind in LAUNCH_KINDS:
                    launches[e.correlation_id()] = (tid, t0)
                if e.name() == WINDOW:
                    self.window = (t0, t0 + e.duration_ns(), tid)
        self.launch = [launches.get(c) for c in corr]
        self.host = {tid: sorted(v) for tid, v in host.items()}
        if self.window is None and self.device:
            self.window = (min(t for _, _, t, _ in self.device),
                           max(t + d for _, _, t, d in self.device), None)

    def busy(self) -> List[Tuple[int, int]]:
        if self.window is None:
            return []
        t0, t1, _ = self.window
        return _union((max(t, t0), min(t + d, t1))
                      for _, _, t, d in self.device if t < t1 and t + d > t0)


class Trace:
    """The two profiled stretches of `units` steps or calls each."""

    def __init__(self, device_prof, host_prof, units: int):
        self.units = units
        self.dev = _Stretch(device_prof)
        self.host = _Stretch(host_prof)

    # ---------------------------------------------- the device's stretch
    @property
    def window_s(self) -> float:
        if self.dev.window is None:
            return 0.0
        t0, t1, _ = self.dev.window
        return (t1 - t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.dev.busy()) / 1e9

    def launches(self) -> int:
        """Kernels run in the stretch."""
        return sum(1 for kind, *_ in self.dev.device if kind == "kernel")

    def kernels(self, substrings: Sequence[str]) -> Tuple[int, float]:
        """(count, seconds) of the kernels whose names hold a substring."""
        n, ns = 0, 0
        for kind, name, _, d in self.dev.device:
            if kind == "kernel" and any(s in name for s in substrings):
                n, ns = n + 1, ns + d
        return n, ns / 1e9

    def top_device_ops(self, k: int = 10) -> List[List]:
        """The k device operations (by name) that took most seconds."""
        by = defaultdict(int)
        for _, name, _, d in self.dev.device:
            by[name[:160]] += d
        return [[n, ns / 1e9] for n, ns in
                sorted(by.items(), key=lambda x: -x[1])[:k]]

    # ------------------------------------------------ the host's stretch
    def under(self, prefixes: Sequence[str]) -> float:
        """Device seconds of the operations launched while a host range
        whose name starts with a prefix was open on the launching
        thread."""
        s = self.host
        spans = {tid: _union((a, b) for a, b, name in ranges
                             if name.startswith(tuple(prefixes)))
                 for tid, ranges in s.host.items()}
        starts = {tid: [a for a, _ in v] for tid, v in spans.items()}
        ns = 0
        for (_, _, _, d), at in zip(s.device, s.launch):
            if at is None or not spans.get(at[0]):
                continue
            tid, t = at
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and spans[tid][i][1] >= t:
                ns += d
        return ns / 1e9

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle device time in the host's stretch by what the host was
        inside at each gap's middle: the innermost range open on any
        thread, the latest begun where several threads have one (the
        autograd thread during a backward). The k largest sums; gaps
        under GAP_LABEL_MIN_NS are summed as one."""
        s = self.host
        t0, t1, _ = s.window
        edges = [t0] + [x for iv in s.busy() for x in iv] + [t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        by = defaultdict(int)
        long = []
        for a, b in gaps:
            if b - a < GAP_LABEL_MIN_NS:
                by[f"gaps under {GAP_LABEL_MIN_NS // 1000} us"] += b - a
            else:
                long.append((a, b))
        label = [None] * len(long)          # (start, name) a gap
        for ranges in s.host.values():
            ranges = [r for r in ranges if r[2] != WINDOW]
            stack: List[Tuple[int, int, str]] = []
            i = 0
            for g, (a, b) in enumerate(long):
                mid = (a + b) // 2
                while i < len(ranges) and ranges[i][0] <= mid:
                    while stack and stack[-1][1] < ranges[i][0]:
                        stack.pop()
                    stack.append(ranges[i])
                    i += 1
                while stack and stack[-1][1] < mid:
                    stack.pop()
                if stack and (label[g] is None or stack[-1][0] > label[g][0]):
                    label[g] = (stack[-1][0], stack[-1][2])
        for (a, b), lab in zip(long, label):
            by[lab[1][:160] if lab else "(no host range)"] += b - a
        return [[n, ns / 1e9] for n, ns in
                sorted(by.items(), key=lambda x: -x[1])[:k]]


def record(unit: Callable[[], object], units: int, sync) -> Trace:
    """Profile `units` calls of `unit` twice (device alone, then with the
    host's operators), after one call under the profiler that starts it
    up; `sync()` waits for the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # without a card (the tests) the device's stretches record the host
    cuda = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    sync()
    with profile(activities=cuda):
        unit()
        sync()
    with profile(activities=cuda) as device_prof:
        for _ in range(units):
            unit()
        sync()
    with profile(activities=sorted({ProfilerActivity.CPU, *cuda},
                                   key=str)) as host_prof:
        with record_function(WINDOW):
            for _ in range(units):
                unit()
            sync()
    return Trace(device_prof, host_prof, units)
