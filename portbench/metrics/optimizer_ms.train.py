"""Device ms a step in the kernels launched inside the optimizer's
step (torch's `Optimizer.step#<class>.step` range)."""


def read(run):
    if run.kind != "train" or not run.trace.units:
        return None
    ms = run.trace.under(("Optimizer.step#",)) * 1e3 / run.trace.units
    return ms if ms > 0 else None
