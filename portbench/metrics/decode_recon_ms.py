"""Decode and reconstruction (K5b, K4, R): the stage spans decode_* and reconstruct, ms per decode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decode", lambda k: k.startswith("decode_") or k == "reconstruct")
