"""Device ms of the cuDNN bi-GRU a call: the spans launched inside
aten::_cudnn_rnn."""
from benchmark.readers import host_op_ms


def read(run):
    return host_op_ms(run, r"_cudnn_rnn", len(run.traced_calls))
