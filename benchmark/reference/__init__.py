"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy in float32 (TF32 off) on the benchmark's own
weights and inputs: WAV decoding and resampling, Whisper's log-mel and
encoder, the bi-GRU alignment head, the CTC emissions and the
forced-alignment DP's best score. It imports nothing of the program: what
the program derives from the inputs (labels, batches) is worked out again
here from the published definitions.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions without TF32 inside the block."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, s in zip(flags, saved):
            f.allow_tf32 = s
