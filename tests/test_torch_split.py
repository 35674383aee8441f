"""``decompress``'s short-stream split on the CPU: the native scatter
(``native.scatter``) against per-stream ``flat[a:a+k].copy()``, on one to
four threads whose cuts land inside streams; the arrays ``decompress``
returns on that path own their samples; and ``split.parallel`` opens, inside
``split.copies`` inside ``host_split_streams``, exactly where the batch is
two threads' worth of bytes (``native.FRAME_BYTES_PER_THREAD``, set low
here so that the threaded path runs at a test's size)."""

import functools

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from dctpu_torch import native, trace
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.dist import decompress_sharded
from dctpu_torch.format import read_frame, write_frame

# stream lengths (samples), laid end to end in one flat source
LENGTHS = {
    "mixed with zeros between": [0, 37, 0, 0, 1, 250, 0, 3, 1001, 0, 64, 7, 0],
    "one stream": [4099],
    "all empty": [0, 0, 0],
}


def _source(lens, seed=3):
    """(flat int32 samples with a margin either side, starts into it)."""
    lens = np.asarray(lens, np.int64)
    flat = np.random.default_rng(seed).integers(
        -2**31, 2**31, int(lens.sum()) + 20, dtype=np.int64).astype(np.int32)
    return flat, 10 + np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)


def _cuts_inside_a_stream(lens, threads) -> bool:
    """Whether a cut of the streams' bytes over ``threads`` threads (the
    native ``cut``: byte n * t / T) lands strictly inside a stream."""
    ends = 4 * np.cumsum(lens)
    n = int(ends[-1]) if len(lens) else 0
    cuts = [n * t // threads for t in range(1, threads)]
    return any(e - 4 * k < c < e for c in cuts for e, k in zip(ends.tolist(), lens))


@pytest.mark.parametrize("threads", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(LENGTHS))
def test_scatter_equals_the_per_stream_copies(case, threads):
    lens = LENGTHS[case]
    flat, starts = _source(lens)
    if case != "all empty" and threads > 1:
        assert _cuts_inside_a_stream(lens, threads)
    out = tuple(np.full(k, -7, np.int32) for k in lens)
    native.scatter(flat, starts, out, threads)
    want = [flat[a : a + k].copy() for a, k in zip(starts.tolist(), lens)]
    assert len(out) == len(want)
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("threads", [1, 4])
def test_scatter_takes_streams_in_any_order(threads):
    """A directory may list its streams' samples out of order, or share
    them: each array still gets its own slice."""
    lens = np.array(LENGTHS["mixed with zeros between"])
    flat, starts = _source(lens)
    perm = np.random.default_rng(8).permutation(lens.size)
    lens, starts = lens[perm], starts[perm]
    lens[0], starts[0] = lens[1] + 5, starts[1]  # overlaps the next
    out = tuple(np.empty(k, np.int32) for k in lens.tolist())
    native.scatter(flat, starts, out, threads)
    for got, a, k in zip(out, starts.tolist(), lens.tolist()):
        np.testing.assert_array_equal(got, flat[a : a + k])


def _read_only():
    a = np.zeros(4, np.int32)
    a.flags.writeable = False
    return a


@pytest.mark.parametrize("src, starts, out", [
    (np.zeros(8, np.int32), [5], (np.empty(4, np.int32),)),        # past the end
    (np.zeros(8, np.int32), [-1], (np.empty(4, np.int32),)),       # before it
    (np.zeros(8, np.int32), [0, 1], (np.empty(4, np.int32),)),     # starts != arrays
    (np.zeros(8, np.int32), [0], (np.empty(4, np.int64),)),        # not int32
    (np.zeros(8, np.int32), [0], (np.empty(8, np.int32)[::2],)),   # strided
    (np.zeros(8, np.int32), [0], (_read_only(),)),                 # not writable
    (np.zeros(8, np.int64), [0], (np.empty(4, np.int32),)),        # source not int32
    (np.zeros(16, np.int32)[::2], [0], (np.empty(4, np.int32),)),  # source strided
], ids=["past_end", "negative", "count", "dtype", "strided", "read_only",
        "src_dtype", "src_strided"])
def test_scatter_rejects_what_it_cannot_write(src, starts, out):
    with pytest.raises(ValueError):
        native.scatter(src, np.array(starts), out, 2)


# ------------------------------------------------------------ decompress

L = 256


@functools.lru_cache(maxsize=None)
def _case():
    """(streams, frame bytes): streams of 2,000-2,700 samples, one of none
    and one of exactly two blocks."""
    streams, _, _ = synth_corpus(7, 2000, seed=41, mixed_cadence=True)
    streams[1] = np.concatenate([streams[1], streams[2][:700]])
    streams[3] = streams[3][:0]
    streams[5] = streams[5][: 2 * L]
    return streams, write_frame(api.compress(
        streams, CodecConfig(block_len=L, coder="adaptive"), device="cpu"))


def _batch_bytes():
    return 4 * sum(s.size for s in _case()[0])


# the batch as that many threads' worth of bytes (FRAME_BYTES_PER_THREAD
# set to batch // threads): 4 is more than _TOUCH_THREADS takes
THREADED = {"one thread": None, "two threads": 2, "four threads": 4, "capped": 64}


def _threads(monkeypatch, name):
    if THREADED[name] is not None:
        monkeypatch.setattr(native, "FRAME_BYTES_PER_THREAD",
                            _batch_bytes() // THREADED[name])


@pytest.mark.parametrize("mesh", [["cpu"], ["cpu"] * 3], ids=["cpu", "cpu*3"])
@pytest.mark.parametrize("threaded", list(THREADED))
def test_decompress_on_the_flat_path_gives_arrays_that_own_their_samples(
        monkeypatch, threaded, mesh):
    streams, data = _case()
    _threads(monkeypatch, threaded)
    assert api.takes_flat_path(np.array([s.size for s in streams]))
    got = decompress_sharded(read_frame(data), mesh, chunk_blocks=5)
    assert len(got) == len(streams)
    for g, s in zip(got, streams):
        assert g.dtype == np.int32 and g.base is None and g.flags.owndata
        assert g.flags.writeable and g.flags.c_contiguous
        np.testing.assert_array_equal(g, s)


def _decode_spans(data, chunk_blocks=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = api.decompress(read_frame(data), device="cpu", chunk_blocks=chunk_blocks,
                             stage_ms={})
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.name()[len(trace.PREFIX):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(trace.PREFIX))
    return out, spans


def _inside(spans, name, parent):
    """Each span ``name`` lies inside a span ``parent``."""
    return all(any(ps <= s and e <= pe for ps, pe, pn in spans if pn == parent)
               for s, e, n in spans if n == name)


@pytest.mark.parametrize("per_thread, opens", [
    (lambda b: b // 2, True),        # exactly two threads' worth
    (lambda b: b // 4, True),
    (lambda b: b // 2 + 1, False),   # one byte short of two threads' worth
    (lambda b: b, False),
    (lambda b: 4 << 20, False),      # the default: a test's batch is far below
], ids=["two", "four", "just_below", "one", "default"])
def test_split_parallel_opens_from_two_threads_worth_of_bytes(monkeypatch, per_thread,
                                                              opens):
    streams, data = _case()
    monkeypatch.setattr(native, "FRAME_BYTES_PER_THREAD", per_thread(_batch_bytes()))
    out, spans = _decode_spans(data, chunk_blocks=5)
    for g, s in zip(out, streams):
        np.testing.assert_array_equal(g, s)
    names = [n for _, _, n in spans]
    assert names.count("split.copies") == 1
    assert names.count("split.parallel") == opens
    assert _inside(spans, "split.parallel", "split.copies")


@pytest.mark.parametrize("threaded", list(THREADED))
def test_split_copies_nests_in_host_split_streams(monkeypatch, threaded):
    _, data = _case()
    _threads(monkeypatch, threaded)
    _, spans = _decode_spans(data)
    names = {n for _, _, n in spans}
    assert {"split.copies", "host_split_streams", "download.flat"} <= names
    assert _inside(spans, "split.copies", "host_split_streams")
    # the copies start only after the last download has landed
    last_download = max(e for _, e, n in spans if n == "download.flat")
    assert all(s >= last_download for s, _, n in spans if n == "split.copies")
