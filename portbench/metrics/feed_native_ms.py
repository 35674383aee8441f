"""The host feed's plan and native block build: span dctpu.feed.native, ms per encode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "encode", "feed.native")
