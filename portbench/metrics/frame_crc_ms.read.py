"""read_frame's five CRC-32 checks: span dctpu.read_frame.crc, ms per decode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "decode", "read_frame.crc")
