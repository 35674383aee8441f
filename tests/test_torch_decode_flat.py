"""The decode's host tail on the CPU: R writes each shard's valid samples in
stream order (``api.decode_flat``), ``decompress_flat`` downloads them into
one array and ``decompress`` and ``decompress_sharded`` take them by the
mean stream length, into one array and out of it for short streams,
straight into each stream's own array for long ones. Both against the
reference decoder's arrays (``dctpu.codec.api``), with ranges and shards
that cut streams."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dctpu.codec import api as ref_api
from dctpu.format import read_frame as ref_read_frame
from dctpu_torch import trace
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.dist import decompress_sharded
from dctpu_torch.format import read_frame, write_frame

L = 512
CHUNKS = [None, 4, 5]  # 5 and 7 blocks a stream: ranges of 4 and 5 cut them
# the decode's switch set so that each stream is short, or long
PATHS = {"one array": 2**40, "own arrays": 1}
# decompress on one device, decompress_sharded over three
MESHES = {"cpu": ["cpu"], "cpu*3": ["cpu"] * 3}


@functools.lru_cache(maxsize=None)
def _case(coder):
    """(streams, frame bytes, the reference's decompress and
    decompress_flat of them): streams of 2,600 and 3,300 samples, a stream
    of no samples and one of exactly 2 blocks, both coders' blocks under
    "adaptive"."""
    streams, _, _ = synth_corpus(6, 2600, seed=31, cumulative_frac=0.5)
    streams[1] = np.concatenate([streams[1], streams[2][:700]])
    streams[3] = streams[3][:0]
    streams[4] = streams[4][: 2 * L]
    data = write_frame(api.compress(streams, CodecConfig(block_len=L, coder=coder),
                                    device="cpu"))
    ref = ref_read_frame(data)
    return streams, data, ref_api.decompress(ref), ref_api.decompress_flat(ref)


def _switch(monkeypatch, path):
    monkeypatch.setattr(api, "_FLAT_PATH_MAX_MEAN_LEN", PATHS[path])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("chunk_blocks", CHUNKS)
@pytest.mark.parametrize("coder", ["rice", "vertical", "adaptive"])
def test_decompress_equals_the_reference(monkeypatch, coder, chunk_blocks, path,
                                         mesh):
    streams, data, want, _ = _case(coder)
    _switch(monkeypatch, path)
    if mesh == "cpu":
        got = api.decompress(read_frame(data), device="cpu",
                             chunk_blocks=chunk_blocks)
    else:
        got = decompress_sharded(read_frame(data), MESHES[mesh],
                                 chunk_blocks=chunk_blocks)
    assert len(got) == len(want) == len(streams)
    for g, w, s in zip(got, want, streams):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("chunk_blocks", CHUNKS)
@pytest.mark.parametrize("coder", ["rice", "vertical", "adaptive"])
def test_decompress_flat_equals_the_reference(coder, chunk_blocks):
    streams, data, _, (want, want_lens) = _case(coder)
    flat, lens = api.decompress_flat(read_frame(data), device="cpu",
                                     chunk_blocks=chunk_blocks)
    assert flat.dtype == np.int32
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(lens, want_lens)
    np.testing.assert_array_equal(flat, np.concatenate(streams))


@pytest.mark.parametrize("path", list(PATHS))
def test_decompress_returns_arrays_that_own_their_samples(monkeypatch, path):
    """Every array is its own, writable: writing into one changes no other,
    and no array is a view of a buffer that would hold the batch."""
    streams, data, _, _ = _case("adaptive")
    _switch(monkeypatch, path)
    got = api.decompress(read_frame(data), device="cpu", chunk_blocks=4)
    for i, a in enumerate(got):
        assert a.base is None and a.flags.owndata and a.flags.writeable
        a[:] = -1
        for j, (b, s) in enumerate(zip(got, streams)):
            np.testing.assert_array_equal(b, -1 if j <= i else s)


@pytest.mark.parametrize("chunk_blocks", CHUNKS)
def test_the_ranges_hold_exactly_the_valid_samples(monkeypatch, chunk_blocks):
    """decode_flat's ranges hold the frame's valid samples, each once, in
    block order: Σn samples in all, no padding."""
    streams, data, _, _ = _case("adaptive")
    frame = read_frame(data)
    soff, ranges = api.decode_flat(frame, ["cpu"], chunk_blocks=chunk_blocks)
    n = frame.blocks.n.astype(np.int64)
    assert soff.tolist() == [0, *np.cumsum(n).tolist()]
    got = [(x.shape, s0, s1) for x, s0, s1, _ in ranges]
    bounds = api.block_ranges(n.size, chunk_blocks)
    assert got == [((soff[b] - soff[a],), soff[a], soff[b]) for a, b in bounds]
    assert sum(shape[0] for shape, _, _ in got) == n.sum() == sum(s.size for s in streams)


@pytest.mark.parametrize("path, spans", [
    ("one array", {"sync.download", "download.flat"}),
    ("own arrays", {"sync.download", "download.streams"}),
])
def test_decompress_names_its_path_in_a_trace(monkeypatch, path, spans):
    """The long streams' path opens download.streams around a range's
    copies, the short streams' download.flat; both keep one sync.download
    a range and host_split_streams."""
    _, data, _, _ = _case("rice")
    frame = read_frame(data)
    _switch(monkeypatch, path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.decompress(frame, device="cpu", chunk_blocks=4, stage_ms={})
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    ranges = len(api.block_ranges(frame.blocks.num_blocks, 4))
    seen = {name[len(trace.PREFIX):] for name in names
            if name.startswith((trace.PREFIX + "sync.", trace.PREFIX + "download."))}
    assert seen == spans
    assert names.count(trace.PREFIX + "sync.download") == ranges
    assert trace.PREFIX + "host_split_streams" in names


def test_decompress_rejects_a_stream_past_its_blocks():
    _, data, _, _ = _case("rice")
    frame = read_frame(data)
    frame.streams.num_samples[0] += 1
    with pytest.raises(ValueError, match="stream directory"):
        api.decompress(frame, device="cpu")
