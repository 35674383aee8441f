"""The host feed's walks over the stream list and its concatenation: span dctpu.feed.gather, ms per encode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "encode", "feed.gather")
