"""write_frame's five CRC-32 passes: span dctpu.write_frame.crc, ms per encode."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "encode", "write_frame.crc")
