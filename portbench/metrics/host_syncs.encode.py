"""The program's host reads of device results (spans dctpu.sync.*) per encode."""

from portbench.spans import mean_count


def read(run):
    return mean_count(run, "encode", "sync.")
