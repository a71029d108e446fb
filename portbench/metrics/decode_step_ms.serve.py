"""Device ms a greedy decode step: the device ms a call in the operations
launched inside the program's `decode.greedy` span, over the steps a
decode takes (the program's counters `decode.steps` over `decode.calls`,
over the whole process; the traffic is steady)."""

SPAN = "decode.greedy"


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    try:
        from imagecaptioning_tpu_torch.utils.profiling import COUNTERS
    except ImportError:             # a program without the counters
        return None
    calls = COUNTERS.get("decode.calls", 0)
    ms = run.trace.under((SPAN,)) * 1e3 / run.trace.units
    if not calls or ms <= 0:
        return None
    return ms / (COUNTERS["decode.steps"] / calls)
