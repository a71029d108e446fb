"""The training step's host-to-device rate in GB/s: a batch's bytes as
`dense_driver.to_device` copies them (the program's counters
`to_device.bytes` over `to_device.batches`, over the whole process; the
traffic is steady), over the device seconds a step launched inside the
program's `dense.to_device` span (the pageable copies and the labels'
cast)."""

SPAN = "dense.to_device"


def read(run):
    if run.kind != "train" or not run.trace.units:
        return None
    try:
        from imagecaptioning_tpu_torch.utils.profiling import COUNTERS
    except ImportError:             # a program without the counters
        return None
    batches = COUNTERS.get("to_device.batches", 0)
    seconds = run.trace.under((SPAN,)) / run.trace.units
    if not batches or seconds <= 0:
        return None
    return COUNTERS["to_device.bytes"] / batches / seconds / 1e9
