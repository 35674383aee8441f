"""The ranges of blocks an encode runs on the device (spans dctpu.range) per encode."""

from portbench.spans import mean_count


def read(run):
    return mean_count(run, "encode", "range")
