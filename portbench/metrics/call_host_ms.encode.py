"""The encode's host stages (stage_ms host_*) and write_frame, ms per call."""

from portbench.readers import mean_host_s, mean_ms


def read(run):
    host = mean_ms(run, "encode", lambda k: k.startswith("host_"))
    frame = mean_host_s(run, "write_s")
    return None if host is None or frame is None else host + frame
