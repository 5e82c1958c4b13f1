"""The device's idle share of the traced sub-window, %."""
from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
