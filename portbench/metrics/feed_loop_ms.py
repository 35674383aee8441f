"""The host feed's per-stream loop, api.build_blocks_loop: span dctpu.feed.loop, ms per encode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "encode", "feed.loop")
