"""The program's host reads of device results (spans dctpu.sync.*) per decode."""

from portbench.spans import mean_count


def read(run):
    return mean_count(run, "decode", "sync.")
