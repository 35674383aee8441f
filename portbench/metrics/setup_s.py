"""Set-up: process start to the first timed call, seconds."""


def read(run):
    return run.setup_s
