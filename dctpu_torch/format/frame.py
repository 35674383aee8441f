"""DCF1 frame reader/writer (docs/FORMAT.md §5).

Numpy-vectorized: the block table is parsed/serialized as a structured array in
one pass, and per-block payload offsets come from a single prefix sum — this is
what makes fully parallel decode possible (every block's payload location and
warm-up history is known before any payload bit is touched).

Replaces the reference C codec's serial header read/write (SURVEY.md §2.1
"Frame/container format"; reference unavailable — see SURVEY.md §0).

A copy of the module of the same path in ``dctpu``: the port never imports
``dctpu``, whose package import pulls in jax. Its steps are spans
(``dctpu_torch/trace.py``): ``write_frame`` with ``.tables``, ``.payload``,
``.crc`` and ``.join``, ``read_frame`` with ``.sections``, ``.crc``,
``.tables`` and ``.payload``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np

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
from dctpu_torch.format.crc import crc32
from dctpu_torch.trace import span

# Structured dtypes mirror docs/FORMAT.md §5 exactly (little-endian).
STREAM_DIR_DTYPE = np.dtype(
    [
        ("stream_id", "<u8"),
        ("cadence_s", "<u4"),
        ("num_blocks", "<u4"),
        ("num_samples", "<u8"),
        ("first_block", "<u4"),
        ("reserved", "<u4"),
    ]
)
assert STREAM_DIR_DTYPE.itemsize == STREAM_DIR_BYTES

BLOCK_HEADER_DTYPE = np.dtype(
    [
        ("predictor", "u1"),
        ("k", "u1"),
        ("n", "<u2"),
        ("bit_len", "<u4"),
        ("table_idx", "u1"),
        ("coder", "u1"),
        ("reserved", "u1", (2,)),
        ("history", "<i4", (4,)),
        ("reserved2", "<u4"),
    ]
)
assert BLOCK_HEADER_DTYPE.itemsize == BLOCK_HEADER_BYTES

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

    def to_records(self) -> np.ndarray:
        sdir = np.zeros(len(self), dtype=STREAM_DIR_DTYPE)
        sdir["stream_id"] = self.stream_id
        sdir["cadence_s"] = self.cadence_s
        sdir["num_blocks"] = self.num_blocks
        sdir["num_samples"] = self.num_samples
        sdir["first_block"] = self.first_block
        return sdir

    @classmethod
    def from_records(cls, sdir: np.ndarray) -> "StreamDir":
        return cls(
            stream_id=sdir["stream_id"].copy(),
            cadence_s=sdir["cadence_s"].copy(),
            num_samples=sdir["num_samples"].copy(),
            num_blocks=sdir["num_blocks"].copy(),
            first_block=sdir["first_block"].copy(),
        )


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


def write_frame(frame: Frame) -> bytes:
    with span("write_frame"):
        nstreams = len(frame.streams)
        nblocks = frame.blocks.num_blocks

        with span("write_frame.tables"):
            if isinstance(frame.streams, StreamDir):
                sdir = frame.streams.to_records()  # column moves, no per-stream work
            else:
                sdir = np.zeros(nstreams, dtype=STREAM_DIR_DTYPE)
                for i, s in enumerate(frame.streams):
                    sdir[i] = (s.stream_id, s.cadence_s, s.num_blocks,
                               s.num_samples, s.first_block, 0)

            btab = np.zeros(nblocks, dtype=BLOCK_HEADER_DTYPE)
            btab["predictor"] = frame.blocks.predictor
            btab["k"] = frame.blocks.k
            btab["n"] = frame.blocks.n
            btab["bit_len"] = frame.blocks.bit_len
            btab["table_idx"] = frame.blocks.table_idx
            btab["coder"] = frame.blocks.coder_arr()
            btab["history"] = frame.blocks.history

            tparts = [_TABLE_HEADER.pack(len(frame.tables), 0)]
            for t in frame.tables:
                tparts.append(_TABLE_ENTRY.pack(t.order, *t.coeffs))
            tables_b = b"".join(tparts)

            dir_b = sdir.tobytes()
            btab_b = btab.tobytes()
        with span("write_frame.payload"):
            payload_b = np.ascontiguousarray(frame.payload_words, dtype="<u4").tobytes()

        off_dir = FILE_HEADER_BYTES
        off_btab = off_dir + len(dir_b)
        off_tables = off_btab + len(btab_b)
        off_payload = off_tables + len(tables_b)

        header = _FILE_HEADER.pack(
            MAGIC,
            VERSION,
            0,
            frame.block_len,
            nstreams,
            nblocks,
            off_dir,
            off_btab,
            off_tables,
            off_payload,
            len(payload_b),
        )
        with span("write_frame.crc"):
            trailer = _TRAILER.pack(
                crc32(dir_b), crc32(btab_b), crc32(tables_b), crc32(payload_b),
                crc32(header),
            )
        with span("write_frame.join"):
            return b"".join([header, dir_b, btab_b, tables_b, payload_b, trailer])


def read_frame(data: bytes, verify_crc: bool = True) -> Frame:
    with span("read_frame"):
        # Malformed input of any shape (truncation, garbage offsets/counts) must
        # raise ValueError, never struct.error/IndexError — fuzzed in
        # tests/test_format.py.
        if len(data) < FILE_HEADER_BYTES:
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
        ) = _FILE_HEADER.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError("bad DCF1 magic")
        if version != VERSION:
            raise ValueError(f"unsupported DCF version {version}")

        def _section(off: int, size: int, name: str) -> bytes:
            if off < 0 or size < 0 or off + size > len(data):
                raise ValueError(f"truncated DCF1 frame: {name} section")
            return data[off : off + size]

        with span("read_frame.sections"):
            dir_b = _section(off_dir, nstreams * STREAM_DIR_BYTES, "directory")
            btab_b = _section(off_btab, nblocks * BLOCK_HEADER_BYTES, "block_table")
            _section(off_tables, _TABLE_HEADER.size, "tables header")
            ntables, _ = _TABLE_HEADER.unpack_from(data, off_tables)
            tables_b = _section(
                off_tables, _TABLE_HEADER.size + ntables * TABLE_ENTRY_BYTES, "tables"
            )
            payload_b = _section(off_payload, payload_bytes, "payload")

        if verify_crc:
            _section(off_payload + payload_bytes, _TRAILER.size, "trailer")
            c_dir, c_btab, c_tab, c_pay, c_hdr = _TRAILER.unpack_from(
                data, off_payload + payload_bytes
            )
            with span("read_frame.crc"):
                checks = [
                    (c_hdr, crc32(data[:FILE_HEADER_BYTES]), "header"),
                    (c_dir, crc32(dir_b), "directory"),
                    (c_btab, crc32(btab_b), "block_table"),
                    (c_tab, crc32(tables_b), "tables"),
                    (c_pay, crc32(payload_b), "payload"),
                ]
            for want, got, name in checks:
                if want != got:
                    raise ValueError(f"CRC mismatch in {name} section")

        with span("read_frame.tables"):
            sdir = np.frombuffer(dir_b, dtype=STREAM_DIR_DTYPE)
            streams = StreamDir.from_records(sdir)  # no per-stream objects (config 5)

            btab = np.frombuffer(btab_b, dtype=BLOCK_HEADER_DTYPE)
            blocks = BlockHeaders(
                predictor=btab["predictor"].copy(),
                k=btab["k"].copy(),
                n=btab["n"].copy(),
                bit_len=btab["bit_len"].copy(),
                table_idx=btab["table_idx"].copy(),
                history=btab["history"].copy(),
                coder=btab["coder"].copy(),
            )

            tables = []
            toff = _TABLE_HEADER.size
            for _ in range(ntables):
                order, c0, c1, c2, c3 = _TABLE_ENTRY.unpack_from(tables_b, toff)
                tables.append(LpcTable(order=order, coeffs=(c0, c1, c2, c3)))
                toff += TABLE_ENTRY_BYTES

        with span("read_frame.payload"):
            payload_words = np.frombuffer(payload_b, dtype="<u4").copy()
        return Frame(
            block_len=block_len,
            streams=streams,
            blocks=blocks,
            tables=tuple(tables),
            payload_words=payload_words,
        )
