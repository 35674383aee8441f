"""95th percentile of every decode's host-clock time in the window (read_frame + decode), ms."""

from portbench.readers import p95_ms


def read(run):
    return p95_ms(run, "decode")
