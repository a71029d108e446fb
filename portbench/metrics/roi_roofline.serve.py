"""The ROI kernels' share of their roofline: the summed least time of
each launch of K1 (portbench.roi_bounds, from the cell's shapes)
over their summed device time in the trace."""

from portbench.roi_bounds import KERNELS


def read(run):
    if run.kind != "serve":
        return None
    bound_ms = took_s = 0.0
    for k, per_launch in run.roi_bounds.items():
        n, s = run.trace.kernels([KERNELS[k]])
        bound_ms += n * per_launch
        took_s += s
    if took_s <= 0:
        return None
    return bound_ms / (took_s * 1e3) * 100
