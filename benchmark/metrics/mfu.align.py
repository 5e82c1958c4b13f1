"""Model FLOPs of the window's completed work over its wall time, as a
share of the bf16 dense peak, %."""
from benchmark import roofline


def read(run):
    return roofline.mfu(run.flops, run.window_s) if run.flops else None
