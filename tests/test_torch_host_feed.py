"""The port's host feed for many streams (build_blocks_flat and its
dispatch, decompress_flat) vs the JAX reference's, mirroring
tests/test_host_feed.py, and the bounded passes (chunk_blocks) and decode
backend names of compress / decompress against the single pass.
"""

import numpy as np
import pytest

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.corpus import synth_corpus
from dctpu.format import read_frame as ref_read_frame
from dctpu.format import write_frame as ref_write_frame
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
    assert _equal(got, api.build_blocks_loop(streams, L))
    assert _equal(got, api.build_blocks(streams, L))
    with pytest.raises(ValueError, match="samples for stream lengths"):
        api.build_blocks_flat(flat[1:], lens, L)


def _dispatch(monkeypatch, streams, L):
    """build_blocks(streams, L) -> (its arrays, the paths it took)."""
    taken = []
    for name in ("build_blocks_flat", "build_blocks_loop"):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _f=real, _n=name:
                            taken.append(_n) or _f(*a))
    return api.build_blocks(streams, L), taken


def test_build_blocks_dispatches_flat_path(monkeypatch):
    """Below a mean of _FLAT_PATH_MAX_MEAN_LEN samples per stream,
    build_blocks takes the flat path: the reference's arrays."""
    rng = np.random.default_rng(4)
    streams = _corpus(rng, 300, api._FLAT_PATH_MAX_MEAN_LEN)
    got, taken = _dispatch(monkeypatch, streams, 128)
    assert taken == ["build_blocks_flat"]
    assert _equal(got, ref_api.build_blocks(streams, 128))


def test_build_blocks_dispatches_loop_for_long_streams(monkeypatch):
    """From a mean of _FLAT_PATH_MAX_MEAN_LEN samples per stream on, and
    for no streams, build_blocks takes the per-stream loop, whatever the
    stream count: the reference's arrays."""
    rng = np.random.default_rng(6)
    for n_streams in (12, 300):
        streams = _corpus(rng, n_streams, 3 * api._FLAT_PATH_MAX_MEAN_LEN)
        got, taken = _dispatch(monkeypatch, streams, 128)
        assert taken == ["build_blocks_loop"]
        assert _equal(got, ref_api.build_blocks(streams, 128))
    got, taken = _dispatch(monkeypatch, [], 128)
    assert taken == ["build_blocks_loop"]
    assert _equal(got, ref_api.build_blocks([], 128))


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
