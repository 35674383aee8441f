"""The generator: the same seed gives the same bytes, on the device the
benchmark runs it on (here the CPU)."""

import numpy as np
import pytest
import torch

from portbench import loop, generator, registry

SIGNAL = registry.config("headend-15min")["signal"]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 7])
def test_same_seed_same_bytes(seed):
    a = generator.load_profiles(SIGNAL, 64, 96, 900, seed, "cpu")
    b = generator.load_profiles(SIGNAL, 64, 96, 900, seed, "cpu")
    assert a.dtype == torch.int32 and a.shape == (64, 96)
    assert torch.equal(a, b)
    assert not torch.equal(a, generator.load_profiles(SIGNAL, 64, 96, 900, seed + 1, "cpu"))


def test_statistics_follow_the_signal():
    x = generator.load_profiles(dict(SIGNAL, cumulative_frac=0.25), 400, 96, 900, 5, "cpu")
    rising = (torch.diff(x, dim=1) >= 0).all(1)
    assert int(rising.sum()) >= 100  # the 100 registers, and by chance a few more
    power = x[~rising].double()
    assert 0 <= float(power.min()) and float(power.mean()) < 4000


def test_inputs_are_views_of_one_flat_array():
    cfg = dict(registry.config("headend-15min"), num_streams=30)
    (inp,) = loop.make_inputs(cfg, registry.traffic("headend.daily"), 9, "cpu")
    assert len(inp.streams) == 30 and inp.flat.size == 30 * 96
    assert all(np.shares_memory(s, inp.flat) for s in inp.streams)
    per = loop.make_inputs(dict(registry.config("dataport-1min"), samples_per_stream=500),
                              dict(registry.traffic("dataport.file"), inputs=3), 9, "cpu")
    assert [len(i.streams) for i in per] == [1, 1, 1]
    assert len({i.digest() for i in per}) == 3
