"""format.read_frame on the host clock, ms per decode."""

from portbench.readers import mean_host_s


def read(run):
    return mean_host_s(run, "read_s")
