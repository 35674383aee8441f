"""The port's host feed (build_blocks, build_blocks_flat, decompress_flat)
vs the JAX reference's, mirroring
tests/test_host_feed.py, build_blocks' walk over stream lists of every
kind, and the bounded passes (chunk_blocks) and decode backend names of
compress / decompress against the single pass.
"""

import sys

import numpy as np
import pytest

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.corpus import synth_corpus
from dctpu.format import read_frame as ref_read_frame
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch import native
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.format.frame import StreamDir, read_frame, write_frame


def _corpus(rng, n_streams, max_len):
    return [
        rng.integers(-(2**20), 2**20, size=int(sz), dtype=np.int32)
        for sz in rng.integers(0, max_len, size=n_streams)
    ]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("L", [128, 256])
def test_build_blocks_flat_matches_reference(L):
    rng = np.random.default_rng(3)
    streams = _corpus(rng, 40, 3 * L + 7)
    lens = np.array([s.size for s in streams], np.int64)
    flat = np.concatenate(streams)
    got = api.build_blocks_flat(flat, lens, L)
    assert _equal(got, ref_api.build_blocks_flat(flat, lens, L))
    assert _equal(got, api.build_blocks_flat_plain(flat, lens, L))
    assert _equal(got, api.build_blocks(streams, L))
    with pytest.raises(ValueError, match="samples for stream lengths"):
        api.build_blocks_flat(flat[1:], lens, L)


class _Tagged(np.ndarray):
    """A subclass of ndarray: build_blocks casts it, as it casts lists."""


def _unaligned(a):
    """a's samples (int32) in an array whose data is not 4-byte aligned."""
    buf = np.zeros(4 * a.size + 1, np.uint8)
    out = buf[1:].view(np.int32) if a.size else np.zeros(0, np.int32)
    out[:] = a
    return out


# each kind: (samples int32, rng) -> one stream of those samples
KINDS = {
    "int32": lambda a, rng: a.copy(),
    "strided": lambda a, rng: np.repeat(a, 2)[::2],
    "big_endian": lambda a, rng: a.astype(">i4"),
    "int16": lambda a, rng: (a % 30000).astype(np.int16),
    "int64": lambda a, rng: a.astype(np.int64),
    "float64": lambda a, rng: a.astype(np.float64),
    "list": lambda a, rng: a.tolist(),
    "two_d": lambda a, rng: (a.reshape(2, -1) if a.size % 2 == 0
                             else a.reshape(1, -1)),
    "zero_d": lambda a, rng: np.array(a[0] if a.size else 7, np.int32),
    "zero_d_int64": lambda a, rng: np.array(a[0] if a.size else 7, np.int64),
    "empty": lambda a, rng: np.zeros(0, np.int32),
    "subclass": lambda a, rng: a.copy().view(_Tagged),
    "unaligned": lambda a, rng: _unaligned(a),
}


def _mixed(kinds, n_streams=300, max_len=500, seed=0):
    """n_streams streams of the given kinds in turn; "views" makes int32
    views of one flat array."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len, size=n_streams)
    flat = rng.integers(-(2**20), 2**20, size=int(lens.sum()), dtype=np.int32)
    parts = np.split(flat, np.cumsum(lens)[:-1])
    if kinds == ("views",):
        return parts
    return [KINDS[kinds[i % len(kinds)]](a, rng) for i, a in enumerate(parts)]


FEED_CASES = {
    "views": ("views",),
    "separate_int32": ("int32",),
    "strided": ("int32", "strided"),
    "big_endian": ("big_endian", "int32"),
    "other_dtypes": ("int16", "int64", "float64", "int32"),
    "lists": ("list", "int32"),
    "zero_d_and_two_d": ("zero_d", "two_d", "zero_d_int64", "int32"),
    "with_empty": ("empty", "int32", "empty", "int64"),
    "subclass": ("subclass", "int32"),
    "unaligned": ("unaligned", "int32"),
    "every_kind": tuple(KINDS),
    "only_empty": ("empty",),
}


@pytest.mark.parametrize("as_tuple", [False, True], ids=["list", "tuple"])
@pytest.mark.parametrize("case", sorted(FEED_CASES))
def test_build_blocks_walks_every_kind_of_stream(case, as_tuple):
    """build_blocks reads int32 ndarrays in place and casts every other
    stream: the reference's arrays and build_blocks_flat's on the
    concatenation, byte for byte, for a list or a tuple of streams."""
    streams = _mixed(FEED_CASES[case], seed=len(case))
    if as_tuple:
        streams = tuple(streams)
    in_place = [type(s) is np.ndarray and s.dtype == np.int32 and s.dtype.isnative
                and s.flags.c_contiguous and s.flags.aligned for s in streams]
    cast = [np.asarray(s, np.int32).ravel() for s in streams]
    lens = np.array([a.size for a in cast], np.int64)
    walked, addr, marked = native.stream_addresses(tuple(streams))
    assert marked.tolist() == [i for i, ok in enumerate(in_place) if not ok]
    assert np.array_equal(walked[in_place], lens[in_place])
    assert np.array_equal(addr[in_place],
                          [a.ctypes.data for a, ok in zip(cast, in_place) if ok])
    got = api.build_blocks(streams, 128)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(
        got, ref_api.build_blocks(streams, 128)))
    assert _equal(got, api.build_blocks_flat(np.concatenate(cast), lens, 128))


def test_build_blocks_keeps_no_reference():
    """The walk and the casts take no lasting reference to any stream."""
    streams = _mixed(tuple(KINDS), seed=9)
    before = [sys.getrefcount(s) for s in streams]
    api.build_blocks(streams, 128)
    assert [sys.getrefcount(s) for s in streams] == before


@pytest.mark.parametrize("bad", [[2**40], "abc", [[1, 2], [3]]],
                         ids=["overflow", "string", "ragged"])
def test_build_blocks_raises_as_the_reference(bad):
    """A stream that np.asarray(s, np.int32) rejects raises the exception
    type the reference raises."""
    streams = _mixed(("int32",), seed=2)
    streams[100] = bad
    with pytest.raises(Exception) as want:
        ref_api.build_blocks(streams, 128)
    with pytest.raises(type(want.value)):
        api.build_blocks(streams, 128)


def _dispatch(monkeypatch, streams, L):
    """build_blocks(streams, L) -> (its arrays, the paths it took)."""
    taken = []
    real = api.build_blocks_at
    monkeypatch.setattr(api, "build_blocks_at",
                        lambda *a: taken.append("build_blocks_at") or real(*a))
    return api.build_blocks(streams, L), taken


def test_build_blocks_dispatches_flat_path(monkeypatch):
    """Short streams take the native feed: the reference's arrays."""
    rng = np.random.default_rng(4)
    streams = _corpus(rng, 300, 1536)
    got, taken = _dispatch(monkeypatch, streams, 128)
    assert taken == ["build_blocks_at"]
    assert _equal(got, ref_api.build_blocks(streams, 128))


def test_build_blocks_dispatches_loop_for_long_streams(monkeypatch):
    """Streams longer on average than _FLAT_PATH_MAX_MEAN_LEN samples, and
    no streams, take the same native feed: the reference's arrays."""
    rng = np.random.default_rng(6)
    lens = rng.integers(api._FLAT_PATH_MAX_MEAN_LEN, 3 * api._FLAT_PATH_MAX_MEAN_LEN,
                        size=12)
    streams = [rng.integers(-(2**20), 2**20, size=int(k), dtype=np.int32)
               for k in lens]
    assert not api.takes_flat_path(lens)
    for L in (128, 4096):
        got, taken = _dispatch(monkeypatch, streams, L)
        assert taken == ["build_blocks_at"]
        assert _equal(got, ref_api.build_blocks(streams, L))
    got, taken = _dispatch(monkeypatch, [], 128)
    assert taken == ["build_blocks_at"]
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, ref_api.build_blocks([], 128)))


# a switch below the streams' mean length: the feed is the same either side
LOW_SWITCH = 64


def test_build_blocks_ravels_many_two_d_streams(monkeypatch):
    """300 int32 streams of shape (2, m) at L=128: the reference's arrays
    (its flat path ravels each stream), whatever the decode's switch."""
    monkeypatch.setattr(api, "_FLAT_PATH_MAX_MEAN_LEN", LOW_SWITCH)
    rng = np.random.default_rng(7)
    streams = [rng.integers(-(2**20), 2**20, size=(2, int(m)), dtype=np.int32)
               for m in rng.integers(0, 300, size=300)]
    got = api.build_blocks(streams, 128)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(
        got, ref_api.build_blocks(streams, 128)))


def test_compress_of_two_d_streams_is_the_reference_frame(monkeypatch):
    """Three streams of shape (2, 100): the reference's frame of their
    samples in order, whatever the decode's switch."""
    monkeypatch.setattr(api, "_FLAT_PATH_MAX_MEAN_LEN", LOW_SWITCH)
    rng = np.random.default_rng(8)
    streams = [rng.integers(-(2**20), 2**20, size=(2, 100), dtype=np.int32)
               for _ in range(3)]
    got = write_frame(api.compress(streams, CodecConfig(block_len=128),
                                   device="cpu"))
    want = ref_write_frame(ref_api.compress([s.ravel() for s in streams],
                                            RefConfig(block_len=128)))
    assert got == want


def test_streamdir_frame_and_flat_decode():
    rng = np.random.default_rng(5)
    streams = _corpus(rng, 30, 500)
    frame = api.compress(streams, CodecConfig(block_len=128, coder="adaptive"),
                         device="cpu")
    assert isinstance(frame.streams, StreamDir)
    data = write_frame(frame)
    ref_frame = ref_api.compress(streams, RefConfig(block_len=128, coder="adaptive"))
    assert data == ref_write_frame(ref_frame)
    flat, lens = api.decompress_flat(read_frame(data), device="cpu")
    ref_flat, ref_lens = ref_api.decompress_flat(ref_read_frame(data))
    assert np.array_equal(flat, ref_flat) and np.array_equal(lens, ref_lens)
    assert np.array_equal(flat, np.concatenate(streams))
    assert np.array_equal(lens, [s.size for s in streams])
    # a directory given as a list of StreamMeta
    listed = read_frame(data)
    listed.streams = list(listed.streams)
    flat2, lens2 = api.decompress_flat(listed, device="cpu", chunk_blocks=7)
    assert np.array_equal(flat2, flat) and np.array_equal(lens2, lens)


@pytest.mark.parametrize("coder", ["adaptive", "rice", "vertical"])
def test_chunked_passes_equal_single_pass(coder):
    streams, ids, cads = synth_corpus(5, 2500, seed=8, mixed_cadence=True,
                                      cumulative_frac=0.4)
    cfg = CodecConfig(block_len=256, coder=coder)
    want = write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))
    for chunk in (3, 10**6):
        got = api.compress(streams, cfg, ids, cads, device="cpu", chunk_blocks=chunk)
        assert write_frame(got) == want, chunk
    frame = read_frame(want)
    for chunk in (None, 4):
        for backend in api.DECODE_BACKENDS:
            out = api.decompress(frame, device="cpu", chunk_blocks=chunk,
                                 backend=backend)
            assert _equal(out, streams), (chunk, backend)


def test_decode_backend_names_follow_reference():
    """A name the reference's decoder does not know raises ValueError at a
    RICE group, as the reference's does, and passes a VERTICAL-only
    frame."""
    streams, _, _ = synth_corpus(2, 1500, seed=6)
    rice = read_frame(write_frame(api.compress(
        streams, CodecConfig(block_len=256), device="cpu")))
    vert = read_frame(write_frame(api.compress(
        streams, CodecConfig(block_len=256, coder="vertical"), device="cpu")))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ref_api.decompress(rice, backend="bogus")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        api.decompress(rice, device="cpu", backend="bogus")
    assert _equal(ref_api.decompress(vert, backend="bogus"), streams)
    assert _equal(api.decompress(vert, device="cpu", backend="bogus"), streams)
