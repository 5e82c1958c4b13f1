"""The trace arithmetic on synthetic spans: the busy union, the idle gaps
charged to the launching host op, the spans launched inside a host op, and
the launch calls counted."""

import pytest

from benchmark import trace
from benchmark.trace import DeviceSpan, HostOp, Trace


@pytest.fixture
def tr():
    host = [HostOp("aten::_cudnn_rnn", 0, 50, 1, 10), HostOp("aten::mm", 10, 12, 1, 11),
            HostOp("aten::copy_", 60, 70, 1, 12), HostOp("aten::mm", 10, 12, 2, 13)]
    device = [DeviceSpan(5, 20, "gemm", 11), DeviceSpan(15, 30, "rnn_cell", 10),
              DeviceSpan(40, 45, "rnn_cell", 10), DeviceSpan(80, 90, "Memcpy HtoD", 12),
              DeviceSpan(95, 100, "other", 13)]
    return Trace(device, host, launches=5, window_s=100e-6)


def test_busy_is_the_union(tr):
    assert tr.busy_s() == pytest.approx((25 + 5 + 10 + 5) * 1e-6)
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25


def test_idle_gaps_by_launching_op(tr):
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::_cudnn_rnn"] == pytest.approx(10e-6)
    assert gaps["aten::copy_"] == pytest.approx(35e-6)
    assert gaps["aten::mm"] == pytest.approx(5e-6)


def test_spans_launched_within_an_op(tr):
    names = sorted(s.name for s in tr.launched_within(r"_cudnn_rnn"))
    assert names == ["gemm", "rnn_cell", "rnn_cell"]   # the mm on thread 2 is outside


def test_top_ops(tr):
    assert tr.top_device_ops(1) == [["rnn_cell", pytest.approx(20e-6)]]


@pytest.mark.parametrize("name,counted", [("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True),
                                          ("cuLaunchKernel", True), ("cudaGraphLaunch", True),
                                          ("cudaMemcpyAsync", False), ("cudaLaunchHostFunc", False)])
def test_launch_calls(name, counted):
    assert bool(trace.LAUNCH_CALLS.match(name)) == counted
