"""The encode's copy of the blocks to the card: stage_ms upload, ms per encode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "encode", lambda k: k == "upload")
