"""The ranges of blocks a decode runs on the device (spans dctpu.range) per decode."""

from portbench.spans import mean_count


def read(run):
    return mean_count(run, "decode", "range")
