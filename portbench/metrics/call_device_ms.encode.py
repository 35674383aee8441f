"""The encode's device stage spans (upload, select, emit_*, compact, download), ms per call."""

from portbench.readers import mean_ms


def read(run):
    return mean_ms(run, "encode", lambda k: not k.startswith("host_"))
