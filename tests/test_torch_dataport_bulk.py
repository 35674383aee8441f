"""The port on the shapes of the Dataport bulk archive (portbench's
``dataport-1min-bulk`` configuration, ``dataport.bulk`` cell), on the CPU:
homes long enough for ``decompress`` to download each into its own array,
built by the native feed into 35 blocks of 4096 each with a 736-sample
tail and histories carried across block boundaries, coded at FORMAT's
defaults. The frame is held byte for byte to the benchmark's
plain reference, and ``decompress`` gives each home back."""

import functools

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from dctpu_torch import trace
from dctpu_torch.codec import api
from dctpu_torch.format.frame import read_frame, write_frame
from portbench import check, loop, program, registry

HOMES, SAMPLES = 3, 140000  # a mean of 140,000 >= the decode's switch, 131,072
CFG = dict(registry.config("dataport-1min-bulk"), num_streams=HOMES,
           samples_per_stream=SAMPLES)
SEED = 2**31 + 2020


@functools.lru_cache(maxsize=None)
def _batch():
    """The cell's one input at this size: the homes as views of one flat
    array, made by the benchmark's generator from the seed."""
    (inp,) = loop.make_inputs(CFG, registry.traffic("dataport.bulk"), SEED, "cpu")
    return inp


def _compress():
    inp = _batch()
    return api.compress(inp.streams, program.settings(CFG), inp.ids, inp.cadences,
                        device="cpu")


@functools.lru_cache(maxsize=None)
def _frame_bytes():
    return write_frame(_compress())


def test_the_homes_take_the_loop_feed_in_many_blocks_with_a_tail(monkeypatch):
    """The homes take the native feed, which is the only one, and are
    long enough for decompress's own arrays."""
    inp = _batch()
    assert len(inp.streams) == HOMES and all(s.size == SAMPLES for s in inp.streams)
    assert not api.takes_flat_path(inp.lens)
    taken, real = [], api.build_blocks_at
    monkeypatch.setattr(api, "build_blocks_at",
                        lambda addr, lens, L: taken.append(lens.tolist())
                        or real(addr, lens, L))
    nb = api.build_blocks(inp.streams, CFG["block_len"])[3]
    assert taken == [[SAMPLES] * HOMES]
    assert nb.tolist() == [35] * HOMES
    n = read_frame(_frame_bytes()).blocks.n.astype(np.int64).reshape(HOMES, 35)
    assert (n[:, :-1] == 4096).all() and (n[:, -1] == 736).all()


def test_the_frame_is_the_plain_reference_frame():
    ((want, _),) = check.reference([_batch()], CFG, "cpu")
    assert _frame_bytes() == want


def test_decompress_gives_each_home_back():
    out = api.decompress(read_frame(_frame_bytes()), device="cpu")
    assert len(out) == HOMES
    for got, home in zip(out, _batch().streams):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, home)


def test_the_round_trip_opens_the_loop_feed_and_the_split():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame = _compress()
        api.decompress(read_frame(write_frame(frame)), device="cpu")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"dctpu.feed.native", "dctpu.host_split_streams"} <= names
    assert not {"dctpu.feed.loop", "dctpu.host_flatten"} & names
    assert trace.PREFIX + "feed.gather" in names


@pytest.mark.parametrize("home", range(HOMES))
def test_each_home_has_its_own_directory_entry(home):
    sdir = read_frame(_frame_bytes()).streams
    inp = _batch()
    assert int(sdir.num_samples[home]) == SAMPLES
    assert int(sdir.stream_id[home]) == int(inp.ids[home])
    assert int(sdir.cadence_s[home]) == CFG["cadence_s"]
    assert int(sdir.first_block[home]) == 35 * home
