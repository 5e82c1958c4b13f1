"""The encoder attention kernel's least time over its device time, %."""
from benchmark import roofline
from benchmark.readers import roofline_share

KERNELS = r"\battention_fwd_kernel\b"


def read(run):
    return roofline_share(run, KERNELS, KERNELS, lambda s: roofline.attention_forward(
        s["batch"], s["frames"], s["heads"]))
