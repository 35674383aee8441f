"""Emission and compaction: the stage spans emit_* and compact, ms per encode."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "encode", lambda k: k.startswith("emit_") or k == "compact")
