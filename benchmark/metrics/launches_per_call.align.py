"""Kernel and graph launch calls a call, from the host's runtime events."""
from benchmark.readers import launches_per


def read(run):
    return launches_per(run, len(run.traced_calls))
