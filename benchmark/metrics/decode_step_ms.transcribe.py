"""Device ms of a decode step: the spans launched inside the program's
decode.step spans over the number of those spans."""
from benchmark.decode_spans import step_device_s, steps_by_batch


def read(run):
    steps, busy = steps_by_batch(run), step_device_s(run)
    if not steps or busy is None:
        return None
    return 1e3 * busy / sum(steps)
