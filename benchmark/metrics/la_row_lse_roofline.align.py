"""The class normaliser's (row log-sum-exp) least time over the device
time of its kernels (the split of w, the product-and-reduce, the merge), %."""
from benchmark import roofline
from benchmark.readers import roofline_share

KERNELS = r"\b(row_lse_kernel|split_lo_kernel|merge_kernel)\b"
ONCE = r"\brow_lse_kernel\b"


def read(run):
    return roofline_share(run, KERNELS, ONCE, lambda s: roofline.row_lse(
        s["batch"] * s["frames"], s["feat"], s["cols"]))
