"""The routed experts' grouped products' share of their roofline: the
summed least time of a call's grouped launches (portbench.moe_bounds,
from the widths and the program's count `moe.assignments`) times the
calls of the device's stretch, over the summed device time of the
grouped-product kernels in it."""

from portbench.moe_bounds import KERNELS


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    bounds = getattr(run.trace, "moe", None)
    if not bounds:
        return None
    _, took_s = run.trace.kernels(KERNELS)
    if took_s <= 0:
        return None
    return bounds["bound_ms"] * run.trace.units / (took_s * 1e3) * 100
