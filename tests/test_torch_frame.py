"""The port's frame I/O (``dctpu_torch/format/frame.py`` over the native host
library, ``csrc/host/frame_io.cpp``) against the reference's
``dctpu.format.frame``: the bytes ``write_frame`` makes and the columns
``read_frame`` gives back, on edge frames and on sections at the size where
frame I/O starts a second thread (``native.frame_threads``), with the rows'
and the payload's bytes one element either side of it; the native CRC-32
against ``zlib.crc32`` on 1 to 8 threads; a flipped byte in each section;
truncations and garbage. Exact equality throughout.
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest

from dctpu.format import frame as ref
from dctpu_torch import native
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig, LpcTable
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format.frame import (
    BlockHeaders,
    Frame,
    StreamDir,
    StreamMeta,
    read_frame,
    write_frame,
)

CUT = 2 * native.FRAME_BYTES_PER_THREAD  # the least section on two threads
DIR_COLUMNS = ("stream_id", "cadence_s", "num_samples", "num_blocks", "first_block")
BLOCK_COLUMNS = ("predictor", "k", "n", "bit_len", "table_idx", "history", "coder")


def _blocks(rng, B, coder=True):
    return BlockHeaders(
        predictor=rng.integers(0, 3, B, dtype=np.uint8),
        k=rng.integers(0, 31, B, dtype=np.uint8),
        n=rng.integers(0, 2**16, B, dtype=np.uint16),
        bit_len=rng.integers(0, 2**32, B, dtype=np.uint32),
        table_idx=rng.integers(0, 256, B, dtype=np.uint8),
        history=rng.integers(-(2**31), 2**31, (B, 4), dtype=np.int32),
        coder=rng.integers(0, 2, B, dtype=np.uint8) if coder else None,
    )


def _dir(rng, S):
    return StreamDir(
        stream_id=rng.integers(0, 2**64, S, dtype=np.uint64),
        cadence_s=rng.integers(0, 2**32, S, dtype=np.uint32),
        num_samples=rng.integers(0, 2**64, S, dtype=np.uint64),
        num_blocks=rng.integers(0, 2**32, S, dtype=np.uint32),
        first_block=rng.integers(0, 2**32, S, dtype=np.uint32),
    )


def _synthetic(S, B, words, seed, coder=True, tables=None):
    rng = np.random.default_rng(seed)
    return Frame(
        block_len=4096,
        streams=_dir(rng, S),
        blocks=_blocks(rng, B, coder),
        tables=CodecConfig().lpc_tables if tables is None else tables,
        payload_words=rng.integers(0, 2**32, words, dtype=np.uint32),
    )


def _compressed(coder="adaptive"):
    streams, ids, cads = synth_corpus(5, 3000, seed=23, mixed_cadence=True)
    return api.compress(streams, CodecConfig(block_len=256, coder=coder), ids, cads,
                        device="cpu")


def _as_list(frame):
    return dataclasses.replace(frame, streams=list(frame.streams))


def _zero_block_stream():
    """A directory with a stream of 0 samples and 0 blocks between two."""
    frame = _synthetic(3, 5, 40, seed=3)
    frame.streams.num_blocks[:] = [2, 0, 3]
    frame.streams.first_block[:] = [0, 2, 2]
    frame.streams.num_samples[:] = [500, 0, 700]
    return frame


CASES = {
    "empty": lambda: _synthetic(0, 0, 0, seed=1, tables=()),
    "no_streams": lambda: _synthetic(0, 0, 0, seed=2),
    "zero_block_stream": _zero_block_stream,
    "coder_none": lambda: _synthetic(4, 9, 77, seed=4, coder=False),
    "stream_meta_list": lambda: _as_list(_synthetic(6, 11, 31, seed=5)),
    "compressed": _compressed,
    "compressed_rice_list": lambda: _as_list(_compressed("rice")),
    # the directory's, the block table's and the payload's bytes one element
    # under, on and one over the size that takes a second thread
    **{f"cut{d:+d}": functools.partial(
        _synthetic, CUT // 32 + d, CUT // 32 + d, CUT // 4 + d, seed=10 + d)
       for d in (-1, 0, 1)},
}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def _reference_frame(frame):
    """The same frame in the reference's classes."""
    if isinstance(frame.streams, StreamDir):
        streams = ref.StreamDir(*(getattr(frame.streams, c) for c in (
            "stream_id", "cadence_s", "num_samples", "num_blocks", "first_block")))
    else:
        streams = [ref.StreamMeta(**dataclasses.asdict(s)) for s in frame.streams]
    return ref.Frame(
        block_len=frame.block_len,
        streams=streams,
        blocks=ref.BlockHeaders(**{c: getattr(frame.blocks, c) for c in BLOCK_COLUMNS}),
        tables=frame.tables,
        payload_words=frame.payload_words,
    )


@functools.lru_cache(maxsize=None)
def _bytes(name):
    return write_frame(_case(name)), ref.write_frame(_reference_frame(_case(name)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_write_frame_is_the_reference_bytes(name):
    got, want = _bytes(name)
    assert type(got) is bytes
    assert got == want


def test_cut_cases_straddle_two_threads():
    """The cut cases' sections take one thread below CUT and two from it
    (on a host of two or more CPUs)."""
    two = min(2, native.host_threads())
    assert native.frame_threads(CUT - 1) == 1
    assert native.frame_threads(CUT) == two
    assert native.frame_threads(1 << 40) == native.host_threads()
    assert native.frame_threads(0) == 1
    for d in (-1, 0, 1):
        frame = _case(f"cut{d:+d}")
        assert frame.payload_words.nbytes == CUT + 4 * d
        assert len(frame.streams) * 32 == frame.blocks.num_blocks * 32 == CUT + 32 * d


def _owned(a):
    return a.flags.owndata and a.flags.c_contiguous and a.flags.writeable


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_frame_columns_are_the_references_and_owned(name):
    data, _ = _bytes(name)
    got, want = read_frame(data), ref.read_frame(data)
    assert got.block_len == want.block_len
    assert [(t.order, t.coeffs) for t in got.tables] == [
        (t.order, t.coeffs) for t in want.tables]
    assert isinstance(got.streams, StreamDir)
    pairs = [(getattr(got.streams, c), getattr(want.streams, c)) for c in DIR_COLUMNS]
    pairs += [(getattr(got.blocks, c), getattr(want.blocks, c)) for c in BLOCK_COLUMNS]
    pairs.append((got.payload_words, want.payload_words))
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert _owned(g)


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview"])
def test_read_frame_takes_any_buffer(kind):
    data, _ = _bytes("compressed")
    buf = {"bytes": bytes, "bytearray": bytearray, "memoryview": memoryview}[kind](data)
    got = read_frame(buf)
    assert write_frame(got) == data
    got.payload_words[0] ^= 1  # its own memory: the input is untouched
    assert bytes(buf) == data


@functools.lru_cache(maxsize=None)
def _random_bytes(n):
    return np.random.default_rng(n).bytes(n)


CRC_LENGTHS = [0, 1, 4095, native.FRAME_BYTES_PER_THREAD - 1,
               native.FRAME_BYTES_PER_THREAD, native.FRAME_BYTES_PER_THREAD + 1,
               64 << 20]


@pytest.mark.parametrize("n", CRC_LENGTHS)
def test_native_crc_is_zlibs_on_one_to_eight_threads(n):
    data = _random_bytes(n)
    want = zlib.crc32(data)
    assert [native.crc32(data, t) for t in range(1, 9)] == [want] * 8


@pytest.mark.parametrize("offset", range(16))
def test_native_crc_is_zlibs_at_every_alignment(offset):
    """The folded middle and the table's head and tail: every start mod 16,
    lengths around the 64-byte step and the 16-byte tail."""
    data = _random_bytes(4096)
    for n in (15, 16, 63, 64, 65, 79, 80, 127, 128, 129, 1000, 4096 - 16):
        piece = data[offset:offset + n]
        assert native.crc32(piece, 1) == native.crc32(piece, 3) == zlib.crc32(piece), n


# a byte of each section that no other check reads: the header's flags, a
# table coefficient, the middle of each other section
SECTIONS = ["header", "directory", "block_table", "tables", "payload"]


def _flip_at(frame, data, section):
    off = np.frombuffer(data[24:56], "<u8")  # dir, btab, tables, payload offsets
    return {
        "header": 6,
        "directory": int(off[0]) + 32 * len(frame.streams) // 2 + 9,
        "block_table": int(off[1]) + 32 * frame.blocks.num_blocks // 2 + 13,
        "tables": int(off[2]) + 4 + 5,
        "payload": int(off[3]) + 4 * frame.payload_words.size // 2 + 1,
    }[section]


@pytest.mark.parametrize("name", ["compressed", "cut+1"])
@pytest.mark.parametrize("section", SECTIONS)
def test_a_flipped_byte_names_its_section(section, name):
    data, _ = _bytes(name)
    bad = bytearray(data)
    bad[_flip_at(_case(name), data, section)] ^= 0x10
    with pytest.raises(ValueError, match=f"CRC mismatch in {section} section"):
        read_frame(bytes(bad))
    read_frame(bytes(bad), verify_crc=False)  # still parses


def test_read_frame_fuzz_never_crashes(rng):
    """Truncations, bit flips and garbage raise ValueError, never anything
    else: the CRCs cover every byte, so no flip survives."""
    data = bytearray(_bytes("compressed")[0])
    for cut in (0, 1, 3, 7, 63, 64, 65, len(data) // 2, len(data) - 21, len(data) - 1):
        with pytest.raises(ValueError):
            read_frame(bytes(data[:cut]))
    for _ in range(60):
        bad = bytearray(data)
        bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        with pytest.raises(ValueError):
            read_frame(bytes(bad))
    for _ in range(20):
        blob = rng.integers(0, 256, size=int(rng.integers(0, 300)), dtype=np.uint8)
        try:
            read_frame(b"DCF1" + blob.tobytes())
        except ValueError:
            pass


def test_garbage_offsets_raise_value_error():
    """A header that points past the end, or a payload of no whole words,
    raises ValueError with the CRCs checked or not."""
    data = _bytes("compressed")[0]
    for field, value in ((40, 1 << 40), (48, 1 << 40), (56, len(data)), (56, 3)):
        bad = bytearray(data)
        bad[field:field + 8] = int(value).to_bytes(8, "little")
        for verify in (True, False):
            with pytest.raises(ValueError):
                read_frame(bytes(bad), verify_crc=verify)


def test_write_frame_casts_columns_as_the_reference():
    """Columns of other integer dtypes (int64 n, int32 k) are cast as the
    reference's structured fields cast them."""
    rng = np.random.default_rng(8)
    frame = _synthetic(3, 6, 12, seed=8, tables=(LpcTable(order=2, coeffs=(1, -2, 3, 0)),))
    frame.blocks.n = rng.integers(0, 2**16, 6).astype(np.int64)
    frame.blocks.k = frame.blocks.k.astype(np.int32)
    frame.streams = [StreamMeta(stream_id=i, cadence_s=60, num_samples=7 * i,
                                num_blocks=2, first_block=2 * i) for i in range(3)]
    assert write_frame(frame) == ref.write_frame(_reference_frame(frame))
