"""Device ms of the encoder a call: the spans launched inside the
program's model.encode span."""
from benchmark.readers import host_op_ms


def read(run):
    return host_op_ms(run, r"^model\.encode$", len(run.traced_calls))
