"""DCF1 frame reader/writer (docs/FORMAT.md §5).

Column-wise: the writer builds the frame in one ``bytes`` object, each byte
written once, the directory and block-table rows straight from their columns
and the payload copied once (``dctpu_torch/native.py``, the host library); the
reader takes each section where it lies in its input and copies each column
and the payload out once. The sections' CRC-32s are cut over host threads by
their size. Per-block payload offsets come from a single prefix sum — this is
what makes fully parallel decode possible (every block's payload location and
warm-up history is known before any payload bit is touched).

Replaces the reference C codec's serial header read/write (SURVEY.md §2.1
"Frame/container format"; reference unavailable — see SURVEY.md §0).

The port's counterpart of the module of the same path in ``dctpu``, byte for
byte in what it writes and reads: the port never imports ``dctpu``, whose
package import pulls in jax. Its steps are spans (``dctpu_torch/trace.py``):
``write_frame`` with ``.tables``, ``.payload`` and ``.crc``, ``read_frame``
with ``.sections``, ``.crc``, ``.tables`` and ``.payload``; inside either
``.crc``, ``crc.parallel`` for each section cut over more than one thread.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np

from dctpu_torch import native
from dctpu_torch.config import LpcTable
from dctpu_torch.constants import (
    BLOCK_HEADER_BYTES,
    FILE_HEADER_BYTES,
    MAGIC,
    STREAM_DIR_BYTES,
    TABLE_ENTRY_BYTES,
    TRAILER_BYTES,
    VERSION,
)
from dctpu_torch.trace import span

# The directory and block-table rows (docs/FORMAT.md §5) are laid out by
# csrc/host/frame_io.cpp (DirRow, BlockRow).

_FILE_HEADER = struct.Struct("<4sHHIIQQQQQQ")
assert _FILE_HEADER.size == FILE_HEADER_BYTES

_TABLE_HEADER = struct.Struct("<HH")
_TABLE_ENTRY = struct.Struct("<B3x4i")
assert _TABLE_ENTRY.size == TABLE_ENTRY_BYTES

_TRAILER = struct.Struct("<IIIII")
assert _TRAILER.size == TRAILER_BYTES


@dataclasses.dataclass
class StreamMeta:
    stream_id: int
    cadence_s: int
    num_samples: int
    num_blocks: int
    first_block: int


class StreamDir:
    """Column-oriented stream directory — the config-5 scale path.

    A million-stream frame must not materialize a million StreamMeta
    objects (round-3 VERDICT missing #3: host-side feeding is the residual
    scaling risk). This wraps the five directory columns as numpy arrays;
    it is list-compatible where the codebase consumes directories
    (len / iteration / indexing yield StreamMeta views), while write_frame
    and read_frame move whole columns (no per-stream Python work).
    """

    __slots__ = ("stream_id", "cadence_s", "num_samples", "num_blocks",
                 "first_block")

    def __init__(self, stream_id, cadence_s, num_samples, num_blocks,
                 first_block):
        self.stream_id = np.asarray(stream_id, dtype=np.uint64)
        self.cadence_s = np.asarray(cadence_s, dtype=np.uint32)
        self.num_samples = np.asarray(num_samples, dtype=np.uint64)
        self.num_blocks = np.asarray(num_blocks, dtype=np.uint32)
        self.first_block = np.asarray(first_block, dtype=np.uint32)

    def __len__(self):
        return int(self.stream_id.size)

    def __getitem__(self, i):
        if isinstance(i, slice):  # list-compatible (ADVICE r4 low #4)
            return [self[j] for j in range(*i.indices(len(self)))]
        return StreamMeta(
            stream_id=int(self.stream_id[i]),
            cadence_s=int(self.cadence_s[i]),
            num_samples=int(self.num_samples[i]),
            num_blocks=int(self.num_blocks[i]),
            first_block=int(self.first_block[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):  # list-compat: concat degrades to a list
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)


@dataclasses.dataclass
class BlockHeaders:
    """Column-oriented block table — the shape the device codec consumes."""

    predictor: np.ndarray  # u8  [B]
    k: np.ndarray          # u8  [B]
    n: np.ndarray          # u16 [B]
    bit_len: np.ndarray    # u32 [B]
    table_idx: np.ndarray  # u8  [B]
    history: np.ndarray    # i32 [B, 4]
    coder: np.ndarray | None = None  # u8 [B]; None -> all RICE

    def coder_arr(self) -> np.ndarray:
        if self.coder is None:
            return np.zeros(self.num_blocks, dtype=np.uint8)
        return self.coder

    @property
    def num_blocks(self) -> int:
        return int(self.predictor.shape[0])

    def word_counts(self, block_len: int) -> np.ndarray:
        """u32 words per block payload (sync table + bitstream)."""
        return payload_word_counts(self.bit_len, block_len)

    def word_offsets(self, block_len: int) -> np.ndarray:
        """Exclusive prefix sum of word_counts: payload word offset per block."""
        wc = self.word_counts(block_len)
        off = np.zeros(wc.size + 1, dtype=np.int64)
        np.cumsum(wc, out=off[1:])
        return off


def payload_word_counts(bit_len: np.ndarray, block_len: int) -> np.ndarray:
    """Sync table words + bitstream words per block (docs/FORMAT.md §2.1)."""
    from dctpu_torch.constants import sync_words

    return sync_words(block_len) + (np.asarray(bit_len).astype(np.int64) + 31) // 32


@dataclasses.dataclass
class Frame:
    block_len: int
    streams: List[StreamMeta]
    blocks: BlockHeaders
    tables: Tuple[LpcTable, ...]
    payload_words: np.ndarray  # u32 [total_words], compact, block order


def plan_blocks(stream_lengths: Sequence[int], block_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stream block counts and first-block indices (exclusive scan)."""
    lens = np.asarray(stream_lengths, dtype=np.int64)
    nblocks = (lens + block_len - 1) // block_len
    first = np.zeros(nblocks.size + 1, dtype=np.int64)
    np.cumsum(nblocks, out=first[1:])
    return nblocks, first[:-1]


def _dir_columns(streams) -> StreamDir:
    """The directory as columns: a StreamDir as it is, a list of StreamMeta
    turned into columns once."""
    if isinstance(streams, StreamDir):
        return streams
    return StreamDir(*(
        np.array([getattr(s, f) for s in streams], dtype=t)
        for f, t in (("stream_id", np.uint64), ("cadence_s", np.uint32),
                     ("num_samples", np.uint64), ("num_blocks", np.uint32),
                     ("first_block", np.uint32))))


def _crc(section: np.ndarray) -> int:
    """The section's CRC-32; cut over threads (span ``crc.parallel``) where
    its size asks for more than one (``native.frame_threads``)."""
    threads = native.frame_threads(section.size)
    if threads == 1:
        return native.crc32(section, 1)
    with span("crc.parallel"):
        return native.crc32(section, threads)


def write_frame(frame: Frame) -> bytes:
    """The frame's bytes, each written once into the one ``bytes`` object
    returned: header, rows straight from the columns, tables, payload, then
    the trailer of the sections' CRCs."""
    with span("write_frame"):
        nstreams = len(frame.streams)
        nblocks = frame.blocks.num_blocks
        payload = np.ascontiguousarray(frame.payload_words, dtype="<u4")

        off_dir = FILE_HEADER_BYTES
        off_btab = off_dir + nstreams * STREAM_DIR_BYTES
        off_tables = off_btab + nblocks * BLOCK_HEADER_BYTES
        off_payload = (off_tables + _TABLE_HEADER.size
                       + len(frame.tables) * TABLE_ENTRY_BYTES)
        off_trailer = off_payload + payload.nbytes
        out, buf = native.new_bytes(off_trailer + TRAILER_BYTES)
        sections = (buf[off_dir:off_btab], buf[off_btab:off_tables],
                    buf[off_tables:off_payload], buf[off_payload:off_trailer],
                    buf[:FILE_HEADER_BYTES])

        with span("write_frame.tables"):
            _FILE_HEADER.pack_into(
                buf, 0, MAGIC, VERSION, 0, frame.block_len, nstreams, nblocks,
                off_dir, off_btab, off_tables, off_payload, payload.nbytes)
            d = _dir_columns(frame.streams)
            native.dir_rows(sections[0], d.stream_id, d.cadence_s, d.num_blocks,
                            d.num_samples, d.first_block)
            b = frame.blocks
            native.block_rows(sections[1], b.predictor, b.k, b.n, b.bit_len,
                              b.table_idx, b.coder, b.history)
            _TABLE_HEADER.pack_into(buf, off_tables, len(frame.tables), 0)
            for i, t in enumerate(frame.tables):
                _TABLE_ENTRY.pack_into(
                    buf, off_tables + _TABLE_HEADER.size + i * TABLE_ENTRY_BYTES,
                    t.order, *t.coeffs)
        with span("write_frame.payload"):
            native.copy_bytes(sections[3], payload)
        with span("write_frame.crc"):
            # trailer order (FORMAT §5): directory, block table, tables,
            # payload, header
            _TRAILER.pack_into(buf, off_trailer, *(_crc(sec) for sec in sections))
        return out


def read_frame(data, verify_crc: bool = True) -> Frame:
    """The frame in ``data`` (bytes, bytearray or memoryview). Each section
    is read where it lies in ``data``; every array of the Frame is its own
    copy, contiguous and writable."""
    with span("read_frame"):
        # Malformed input of any shape (truncation, garbage offsets/counts) must
        # raise ValueError, never struct.error/IndexError — fuzzed in
        # tests/test_format.py and tests/test_torch_frame.py.
        buf = np.frombuffer(data, np.uint8)
        if buf.size < FILE_HEADER_BYTES:
            raise ValueError("truncated DCF1 frame: short header")
        (
            magic,
            version,
            _flags,
            block_len,
            nstreams,
            nblocks,
            off_dir,
            off_btab,
            off_tables,
            off_payload,
            payload_bytes,
        ) = _FILE_HEADER.unpack_from(buf, 0)
        if magic != MAGIC:
            raise ValueError("bad DCF1 magic")
        if version != VERSION:
            raise ValueError(f"unsupported DCF version {version}")

        def _section(off: int, size: int, name: str) -> np.ndarray:
            if off < 0 or size < 0 or off + size > buf.size:
                raise ValueError(f"truncated DCF1 frame: {name} section")
            return buf[off : off + size]

        with span("read_frame.sections"):
            dir_b = _section(off_dir, nstreams * STREAM_DIR_BYTES, "directory")
            btab_b = _section(off_btab, nblocks * BLOCK_HEADER_BYTES, "block_table")
            _section(off_tables, _TABLE_HEADER.size, "tables header")
            ntables, _ = _TABLE_HEADER.unpack_from(buf, off_tables)
            tables_b = _section(
                off_tables, _TABLE_HEADER.size + ntables * TABLE_ENTRY_BYTES, "tables"
            )
            payload_b = _section(off_payload, payload_bytes, "payload")

        if verify_crc:
            _section(off_payload + payload_bytes, _TRAILER.size, "trailer")
            c_dir, c_btab, c_tab, c_pay, c_hdr = _TRAILER.unpack_from(
                buf, off_payload + payload_bytes
            )
            with span("read_frame.crc"):
                checks = [
                    (c_hdr, _crc(buf[:FILE_HEADER_BYTES]), "header"),
                    (c_dir, _crc(dir_b), "directory"),
                    (c_btab, _crc(btab_b), "block_table"),
                    (c_tab, _crc(tables_b), "tables"),
                    (c_pay, _crc(payload_b), "payload"),
                ]
            for want, got, name in checks:
                if want != got:
                    raise ValueError(f"CRC mismatch in {name} section")

        with span("read_frame.tables"):
            sid, cad, nblk, nsamp, first = native.dir_columns(dir_b)
            streams = StreamDir(stream_id=sid, cadence_s=cad, num_samples=nsamp,
                                num_blocks=nblk, first_block=first)
            pred, k, n, bit_len, table_idx, coder, history = native.block_columns(btab_b)
            blocks = BlockHeaders(predictor=pred, k=k, n=n, bit_len=bit_len,
                                  table_idx=table_idx, history=history, coder=coder)

            tables = []
            toff = off_tables + _TABLE_HEADER.size
            for _ in range(ntables):
                order, c0, c1, c2, c3 = _TABLE_ENTRY.unpack_from(buf, toff)
                tables.append(LpcTable(order=order, coeffs=(c0, c1, c2, c3)))
                toff += TABLE_ENTRY_BYTES

        with span("read_frame.payload"):
            if payload_bytes % 4:
                raise ValueError("DCF1 payload is not whole u32 words")
            payload_words = np.empty(payload_bytes // 4, dtype="<u4")
            native.copy_bytes(payload_words, payload_b)
        return Frame(
            block_len=block_len,
            streams=streams,
            blocks=blocks,
            tables=tuple(tables),
            payload_words=payload_words,
        )
