"""Raw int32 bytes of every encode in the window over their host-clock time (compress + write_frame), GB/s."""

from portbench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "encode")
