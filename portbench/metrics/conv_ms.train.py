"""Device ms a step in the kernels launched inside the convolution
operators (forward and backward: cuDNN under aten::convolution,
aten::_convolution, aten::convolution_backward)."""

PREFIXES = ("aten::conv", "aten::_conv", "aten::cudnn_conv")


def read(run):
    if run.kind != "train" or not run.trace.units:
        return None
    ms = run.trace.under(PREFIXES) * 1e3 / run.trace.units
    return ms if ms > 0 else None
