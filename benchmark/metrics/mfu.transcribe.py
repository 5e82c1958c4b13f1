"""Model FLOPs of the window's completed work (the encoder and the
decoder's prime and steps, ``roofline.py`` and ``roofline_decode.py``) over
its wall time, as a share of the bf16 dense peak, %."""
from benchmark import roofline


def read(run):
    return roofline.mfu(run.flops, run.window_s) if run.flops else None
