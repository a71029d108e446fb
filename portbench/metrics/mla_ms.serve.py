"""Device ms a call in the operations launched inside the program's
`lm.attn` spans: the region language model's latent attention in every
layer (its norm, projections, cache writes and attention), prefill and
decode."""

SPAN = "lm.attn"


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    ms = run.trace.under((SPAN,)) * 1e3 / run.trace.units
    return ms if ms > 0 else None
