"""Process start to the first timed call, seconds (the harness times it)."""


def read(run):
    return run.setup_s
