"""The port's sharded paths (dctpu_torch.dist) over lists of CPU devices vs
the JAX reference's dctpu.dist over the 8 fake CPU devices of
tests/conftest.py, on the cases of tests/test_sharded.py: the frames are
byte-identical for every coder, block length, mesh size and chunking, and
the decoded streams equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.corpus import synth_corpus
from dctpu.dist import compress_sharded as ref_compress_sharded
from dctpu.dist import decompress_sharded as ref_decompress_sharded
from dctpu.dist import make_mesh as ref_make_mesh
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch.codec import api
from dctpu_torch.config import from_reference
from dctpu_torch.dist import (
    compress_sharded,
    decompress_sharded,
    dryrun_multichip,
    make_mesh,
)
from dctpu_torch.format import read_frame, write_frame
from tests.conftest import stream_cases

CPU = torch.device("cpu")
MESH_SIZES = (1, 3, 8)


def _configs(**fields):
    ref = RefConfig(**fields)
    return ref, from_reference(dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_make_mesh()


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(5, 3000, seed=13, mixed_cadence=True, cumulative_frac=0.4)


@pytest.mark.parametrize("L", [256, 512])
@pytest.mark.parametrize("coder", ["adaptive", "rice", "vertical"])
def test_sharded_frames_match_reference(ref_mesh, corpus, coder, L):
    """Two chunks: 60 blocks at L=256 in chunks of 32, 30 at 512 of 16."""
    streams, ids, cads = corpus
    ref_cfg, cfg = _configs(block_len=L, coder=coder)
    chunk = 8192 // L
    want = ref_write_frame(ref_compress_sharded(
        streams, ref_cfg, ref_mesh, ids, cads, chunk_blocks=chunk))
    assert write_frame(api.compress(streams, cfg, ids, cads, device="cpu")) == want
    for k in MESH_SIZES:
        got = compress_sharded(streams, cfg, [CPU] * k, ids, cads,
                               chunk_blocks=chunk)
        assert write_frame(got) == want, k
    out = decompress_sharded(read_frame(want), [CPU] * 3, chunk_blocks=chunk)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))


def test_sharded_roundtrip_adversarial(ref_mesh):
    streams = stream_cases(np.random.default_rng(1234))
    ref_cfg, cfg = _configs(block_len=512)
    want = ref_write_frame(ref_compress_sharded(streams, ref_cfg, ref_mesh))
    for k in MESH_SIZES:
        frame = compress_sharded(streams, cfg, [CPU] * k)
        assert write_frame(frame) == want, k
        out = decompress_sharded(read_frame(want), [CPU] * k)
        for a, b in zip(streams, out):
            assert np.array_equal(np.asarray(a, np.int32), b)


def test_sharded_decode_matches_reference(ref_mesh):
    """Every decode backend name of the reference gives its streams; a name
    it does not know raises ValueError at the RICE group in both."""
    streams, _, _ = synth_corpus(4, 5000, seed=17, cumulative_frac=0.5)
    ref_cfg, cfg = _configs(block_len=1024)
    data = write_frame(api.compress(streams, cfg, device="cpu"))
    assert data == ref_write_frame(ref_api.compress(streams, ref_cfg))
    frame = read_frame(data)
    want = ref_decompress_sharded(frame, ref_mesh)
    for backend in api.DECODE_BACKENDS:
        for k in MESH_SIZES:
            got = decompress_sharded(frame, [CPU] * k, chunk_blocks=4,
                                     backend=backend)
            assert all(np.array_equal(u, v) for u, v in zip(want, got)), (backend, k)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ref_decompress_sharded(frame, ref_mesh, backend="bogus")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        decompress_sharded(frame, [CPU] * 3, backend="bogus")


def test_sharded_fewer_blocks_than_devices(ref_mesh):
    """3 blocks over 8 devices: five shards are empty."""
    streams = [np.arange(3 * 300, dtype=np.int32)]
    ref_cfg, cfg = _configs(block_len=300)
    want = ref_write_frame(ref_compress_sharded(streams, ref_cfg, ref_mesh))
    assert write_frame(compress_sharded(streams, cfg, [CPU] * 8)) == want
    assert write_frame(compress_sharded(streams, cfg, [CPU] * 8, chunk_blocks=2)) == want
    out = decompress_sharded(read_frame(want), [CPU] * 8)
    assert np.array_equal(out[0], streams[0])
    empty = compress_sharded([], cfg, [CPU] * 8)
    assert write_frame(empty) == write_frame(api.compress([], cfg, device="cpu"))


def test_block_and_shard_ranges():
    assert api.block_ranges(5, None) == [(0, 5)]
    assert api.block_ranges(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert api.block_ranges(0, 2) == [(0, 0)]
    assert api.shard_ranges(0, 3, 8) == [(0, 0, 1), (1, 1, 2), (2, 2, 3)]
    assert api.shard_ranges(4, 11, 3) == [(0, 4, 7), (1, 7, 10), (2, 10, 11)]
    assert api.shard_ranges(2, 2, 4) == [(0, 2, 2)]
    with pytest.raises(ValueError, match="chunk_blocks"):
        api.block_ranges(5, 0)


def test_sharded_stage_times(corpus):
    streams, ids, cads = corpus
    _, cfg = _configs(block_len=256, coder="adaptive")
    enc_ms, dec_ms = {}, {}
    frame = compress_sharded(streams, cfg, [CPU] * 2, ids, cads, chunk_blocks=16,
                             stage_ms=enc_ms)
    decompress_sharded(frame, [CPU] * 2, chunk_blocks=16, stage_ms=dec_ms)
    assert {"upload", "select", "emit_rice", "emit_vertical", "interleave"} <= set(enc_ms)
    assert {"upload", "decode_rice", "decode_vertical", "reconstruct",
            "download"} <= set(dec_ms)


def test_dryrun_multichip_on_cpu_devices():
    dryrun_multichip(4, [CPU] * 4)
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(4, [CPU] * 3)


def test_make_mesh(monkeypatch):
    assert make_mesh([CPU, "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="empty"):
        make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress_sharded([np.arange(10, dtype=np.int32)])
