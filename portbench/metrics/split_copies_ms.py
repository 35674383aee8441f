"""decompress's copies of short streams out of its one flat download: span dctpu.split.copies, ms per decode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "decode", "split.copies")
