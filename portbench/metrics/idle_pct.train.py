"""The share of the traced stretch in which no device operation ran."""


def read(run):
    if run.kind != "train" or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s / run.trace.window_s) * 100
