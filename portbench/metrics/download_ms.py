"""The decode's copy of the samples to the host: stage_ms download, ms per decode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decode", lambda k: k == "download")
