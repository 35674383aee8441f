"""The port's kernels in the encodes: least time (work.py) over device time, %."""

from portbench.readers import kernels_roofline


def read(run):
    return kernels_roofline(run, "encode")
