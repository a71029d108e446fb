"""Device ms a call in the operations launched inside the program's
`lm.prefill` span: the region language model's prefill of every image's
tokens and of every region's token and prompt."""

SPAN = "lm.prefill"


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    ms = run.trace.under((SPAN,)) * 1e3 / run.trace.units
    return ms if ms > 0 else None
