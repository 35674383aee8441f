"""decompress_flat's masked flatten of the decoded blocks: stage_ms host_flatten, ms per decode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decode", lambda k: k == "host_flatten")
