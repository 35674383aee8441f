"""Device kernel launches per encode, from the profiler."""

from portbench.readers import launches_per_call


def read(run):
    return launches_per_call(run, "encode")
