"""The port's kernels in the decodes: least time (work.py) over device time, %."""

from portbench.readers import kernels_roofline


def read(run):
    return kernels_roofline(run, "decode")
