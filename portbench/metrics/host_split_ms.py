"""decompress's split of the decoded blocks into one array per stream: stage_ms host_split_streams, ms per decode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decode", lambda k: k == "host_split_streams")
