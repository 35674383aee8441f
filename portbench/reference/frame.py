"""The DCF1 frame of encoded blocks, written from docs/FORMAT.md §5."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from portbench.reference.codec import Blocks

MAGIC, VERSION = b"DCF1", 2
HEADER = struct.Struct("<4sHHIIQQQQQQ")   # 64 bytes
TRAILER = struct.Struct("<IIIII")         # 20 bytes
DIRECTORY = np.dtype([
    ("stream_id", "<u8"), ("cadence_s", "<u4"), ("num_blocks", "<u4"),
    ("num_samples", "<u8"), ("first_block", "<u4"), ("reserved", "<u4"),
])
BLOCK = np.dtype([
    ("predictor", "u1"), ("k", "u1"), ("n", "<u2"), ("bit_len", "<u4"),
    ("table_idx", "u1"), ("coder", "u1"), ("reserved", "u1", (2,)),
    ("history", "<i4", (4,)), ("reserved2", "<u4"),
])


def crc(b: bytes) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


def frame_bytes(blocks: Blocks, block_len: int, stream_ids, cadences, lens,
                lpc_tables) -> bytes:
    """The frame of these blocks and streams: header, stream directory,
    block table, LPC tables, payload, trailer of CRC-32s."""
    lens = np.asarray(lens, np.int64)
    nb = -(-lens // block_len)
    first = np.zeros(lens.size, np.int64)
    np.cumsum(nb[:-1], out=first[1:])
    d = np.zeros(lens.size, DIRECTORY)
    d["stream_id"], d["cadence_s"] = stream_ids, cadences
    d["num_blocks"], d["num_samples"], d["first_block"] = nb, lens, first
    t = np.zeros(blocks.predictor.size, BLOCK)
    for name in ("predictor", "k", "n", "bit_len", "table_idx", "coder", "history"):
        t[name] = getattr(blocks, name)
    tables = struct.pack("<HH", len(lpc_tables), 0) + b"".join(
        struct.pack("<B3x4i", order, *coeffs) for order, coeffs in lpc_tables)
    sections = [d.tobytes(), t.tobytes(), tables,
                np.ascontiguousarray(blocks.words, "<u4").tobytes()]
    offs = np.cumsum([HEADER.size] + [len(s) for s in sections[:-1]]).tolist()
    header = HEADER.pack(MAGIC, VERSION, 0, block_len, lens.size, t.size, *offs,
                         len(sections[-1]))
    trailer = TRAILER.pack(*(crc(s) for s in sections), crc(header))
    return b"".join([header, *sections, trailer])
