"""Device ms a call in the operations launched inside the program's
`gt.encode` span: the trunk, ROI pooling and fc6/fc7 of every region."""

SPAN = "gt.encode"


def read(run):
    if run.kind != "serve" or not run.trace.units:
        return None
    ms = run.trace.under((SPAN,)) * 1e3 / run.trace.units
    return ms if ms > 0 else None
