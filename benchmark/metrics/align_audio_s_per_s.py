"""Seconds of request audio aligned over the window's wall time."""
from benchmark.readers import rate


def read(run):
    return rate(run, "audio_s")
