"""Device operations (kernels, copies, memsets) launched inside the step
loop's spans (decode.step, decode.select, decode.sync), over the traced
decode.step spans."""
from benchmark.decode_spans import steps_by_batch


def read(run):
    steps = steps_by_batch(run)
    if not steps:
        return None
    found = run.trace.launched_within(r"^decode\.(step|select|sync)$")
    return len(found) / sum(steps) if found else None
