"""format.write_frame on the host clock, ms per encode."""

from portbench.readers import mean_host_s


def read(run):
    return mean_host_s(run, "write_s")
