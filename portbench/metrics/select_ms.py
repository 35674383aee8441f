"""Selection (K1, K2's LPC form): the stage span select, ms per encode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "encode", lambda k: k == "select")
