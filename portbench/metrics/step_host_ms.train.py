"""Host ms a step inside the program's `dense.step` span: the time the
host takes to enqueue a training step (forward, backward and update),
to set beside the device's busy time a step. Recorded with the host's
operators, so the profiler's own cost inflates it."""

SPAN = "dense.step"


def read(run):
    if run.kind != "train" or not run.trace.units:
        return None
    ns = sum(b - a for ranges in run.trace.host.host.values()
             for a, b, name in ranges if name == SPAN)
    return ns / 1e6 / run.trace.units if ns > 0 else None
