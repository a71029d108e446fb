"""Kernels run a call in the traced stretch (profiler, exact)."""


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    return run.trace.launches() / run.trace.units
