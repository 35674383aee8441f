"""The decode's device stage spans (upload, decode_*, reconstruct, download), ms per call."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decode", lambda k: not k.startswith("host_"))
