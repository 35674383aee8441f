"""The host feed, api.build_blocks: stage_ms host_build_blocks, ms per encode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "encode", lambda k: k == "host_build_blocks")
