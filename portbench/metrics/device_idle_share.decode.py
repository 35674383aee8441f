"""Share of the decodes' wall time with nothing running on the device, %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run, "decode")
