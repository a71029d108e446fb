"""Host ms a step inside the program's `rpn.sampler` span: drawing the
sampler's keys, sampling each image's positives and negatives, and the
takes and gathers that pick the regions. This is the host's stretch,
recorded with the host's operators, so the profiler's own cost inflates
it; compare it only with other traced readings."""

SPAN = "rpn.sampler"


def read(run):
    if run.kind != "train" or not run.trace.units:
        return None
    ns = sum(b - a for ranges in run.trace.host.host.values()
             for a, b, name in ranges if name == SPAN)
    return ns / 1e6 / run.trace.units if ns > 0 else None
