"""95th percentile of every encode's host-clock time in the window (compress + write_frame), ms."""

from portbench.readers import p95_ms


def read(run):
    return p95_ms(run, "encode")
