"""Device ms a call in the operations launched inside the program's
`lm.moe` spans: the routed experts (dispatch, the grouped products, the
weighted sum) and the shared experts of every MoE layer, prefill and
decode (the router is in `lm.router`, outside)."""

SPAN = "lm.moe"


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    ms = run.trace.under((SPAN,)) * 1e3 / run.trace.units
    return ms if ms > 0 else None
