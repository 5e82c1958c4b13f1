"""The forced-alignment DP kernel's least time over its device time, %."""
from benchmark import roofline
from benchmark.readers import roofline_share

KERNELS = r"\bviterbi_kernel\b"


def read(run):
    return roofline_share(run, KERNELS, KERNELS, lambda s: roofline.viterbi(
        s["batch"], s["frames"], s["labels"]))
