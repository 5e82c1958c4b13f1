"""The decode steps' least time (their least bytes at the HBM rate,
``roofline_decode.step_bytes``, each batch's steps from 0) over the device
time of the spans launched inside decode.step, %."""
from benchmark import roofline_decode
from benchmark.decode_spans import step_device_s, steps_by_batch


def read(run):
    steps, busy = steps_by_batch(run), step_device_s(run)
    if not steps or busy is None:
        return None
    s = run.shapes
    least = sum(roofline_decode.steps_least_s(s["dims"], s["windows"], s["beam"], s["prompt"], n,
                                              s["elem"]) for n in steps)
    return 100.0 * least / busy
