"""The log-mel kernel's least time over its device time, %."""
from benchmark import roofline
from benchmark.readers import roofline_share

KERNELS = r"\blog10_mel_kernel\b"


def read(run):
    return roofline_share(run, KERNELS, KERNELS, lambda s: roofline.log10_mel(
        s["batch"], s["padded_len"], s["mel_frames"], s["n_mels"], s["fb_nonzero"]))
