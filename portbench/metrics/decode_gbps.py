"""Raw int32 bytes of every decode in the window over their host-clock time (read_frame + decode), GB/s."""

from portbench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "decode")
