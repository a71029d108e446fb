"""The training step's share of the card's dense bf16 peak: the
operations a step needs (portbench.flops, from the shapes) times the
window's steps a second, over the published peak."""

from portbench import peaks


def read(run):
    if run.kind != "serve":
        return None
    p = peaks.for_device(run.device)
    if p is None or not run.units_per_s:
        return None
    return run.flops_per_unit * run.units_per_s / p["bf16_flops"] * 100
