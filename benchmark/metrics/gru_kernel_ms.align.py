"""Device ms of the align head's recurrence kernel a call: the spans
launched inside the program's la_gru_recurrence op (one a bi-GRU layer)."""
from benchmark.readers import host_op_ms


def read(run):
    return host_op_ms(run, r"^la_gru_recurrence$", len(run.traced_calls))
