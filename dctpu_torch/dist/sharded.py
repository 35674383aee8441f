"""Data parallelism over blocks: the counterpart of ``dctpu/dist/sharded.py``.

Blocks are independent (FORMAT §2.1), so each chunk of ``chunk_blocks``
blocks is cut into one contiguous shard per device of the mesh, each shard
runs the single-device range encoder or decoder of ``codec/api.py`` on its
device, and the results are gathered in shard order, which is block
order: the frame equals ``compress``'s. On several cards the shards of a
chunk overlap in selection and in decode, each of which launches every
shard before its first host read; emission reads each shard back before
the next shard's is launched, so the shards emit in turn.

The reference's four jitted block functions (``encode_blocks_sharded``,
``decode_blocks_sharded``, ``adaptive_select_sharded``,
``emit_blocks_sharded``) wrap its single-device bodies in ``shard_map``;
their work here is the range encoder and decoder, so they have no
counterpart of their own. Nor does its padding of each chunk to a multiple
of the mesh size, which exists for JAX's static shapes: a shard with no
blocks is skipped.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.dist.mesh import make_mesh
from dctpu_torch.format.frame import Frame


def compress_sharded(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    mesh: Sequence | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
    chunk_blocks: int | None = api.DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
    stage_ms: dict | None = None,
) -> Frame:
    """Streams -> the frame of ``compress``, each chunk sharded over ``mesh``
    (default: every CUDA device, :func:`make_mesh`). For coder="adaptive"
    each shard runs the whole flow (select, group, emit, compact)."""
    return api.encode_frame(
        streams, cfg or CodecConfig(), stream_ids, cadences, make_mesh(mesh),
        stage_ms, backend, chunk_blocks,
    )


def decompress_sharded(
    frame: Frame,
    mesh: Sequence | None = None,
    chunk_blocks: int | None = api.DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
    stage_ms: dict | None = None,
) -> List[np.ndarray]:
    """Frame -> the streams of ``decompress``, each chunk sharded over
    ``mesh``; each shard uploads only its blocks' compact words."""
    xs = api.decode_blocks_array(frame, make_mesh(mesh), stage_ms, chunk_blocks,
                                 backend)
    return api.split_streams(xs, frame.streams)
