"""Data parallelism over blocks: the counterpart of ``dctpu/dist/sharded.py``.

Blocks are independent (FORMAT §2.1), so each chunk of ``chunk_blocks``
blocks is cut into one contiguous shard per device of the mesh, each shard
runs the single-device range encoder or decoder of ``codec/api.py`` on its
device, and the results are gathered in shard order, which is block
order: the frame equals ``compress``'s. On several cards the shards of a
chunk overlap in selection and in decode, each of which launches every
shard before its first host read; emission reads each shard back before
the next shard's is launched, so the shards emit in turn.

The reference's four block functions (``encode_blocks_sharded``,
``decode_blocks_sharded``, ``adaptive_select_sharded``,
``emit_blocks_sharded``) wrap its single-device bodies in ``shard_map``;
here each cuts its block tensors into one contiguous shard per device of
the mesh (as :func:`api.shard_ranges` cuts a chunk), runs the
single-device function of ``codec/encode.py`` or ``codec/decode.py`` on
each shard's device, launching every shard before the first host read,
and gathers the results in block order on ``mesh[0]``. Unlike the
reference, B need not be a multiple of the mesh size, and nothing is
padded for JAX's static shapes: a shard with no blocks is skipped.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dctpu_torch.codec import api, decode, encode
from dctpu_torch.codec.encode import EncodedBlocks
from dctpu_torch.config import CodecConfig
from dctpu_torch.dist.mesh import make_mesh
from dctpu_torch.format.frame import Frame
from dctpu_torch.kernels.vdec import raise_if_bad_slots


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
    return api.decode_frame(frame, make_mesh(mesh), stage_ms, chunk_blocks,
                            backend)


# ---------------------------------------------------- the block functions


def _on_shards(fn, mesh, tensors):
    """fn(*the shard's slices of tensors, moved to its device) on each
    contiguous shard of their first axis, one per device of mesh; returns
    [(device, result)], every shard launched before any result is read."""
    mesh = make_mesh(mesh)
    B = tensors[0].shape[0]
    return [
        (mesh[i], fn(*(t[a:b].to(mesh[i]) for t in tensors)))
        for i, a, b in api.shard_ranges(0, B, len(mesh))
    ]


def _gather(results, dev) -> List[torch.Tensor]:
    """Each field of the shards' results concatenated in shard order on dev."""
    return [torch.cat([t.to(dev) for t in col]) for col in zip(*results)]


def encode_blocks_sharded(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B]
    history: torch.Tensor,  # [B, 4]
    cfg: CodecConfig,
    mesh: Sequence | None,
    backend: str | None = "auto",
) -> EncodedBlocks:
    """``encode.encode_blocks`` of each shard on its device -> the
    :class:`EncodedBlocks` of the whole batch on ``mesh[0]``."""
    parts = _on_shards(
        lambda *t: encode.encode_blocks(*t, cfg, backend), mesh, (x, n, history))
    return EncodedBlocks(*_gather([r for _, r in parts], parts[0][0]))


def adaptive_select_sharded(
    x: torch.Tensor, n: torch.Tensor, history: torch.Tensor,
    cfg: CodecConfig, mesh: Sequence | None, backend: str | None = "auto",
):
    """``encode.adaptive_select`` of each shard -> (choice, coder, k) of the
    whole batch on ``mesh[0]``."""
    parts = _on_shards(
        lambda *t: encode.adaptive_select(*t, cfg, backend), mesh, (x, n, history))
    return tuple(_gather([r for _, r in parts], parts[0][0]))


def emit_blocks_sharded(
    x: torch.Tensor, n: torch.Tensor, history: torch.Tensor,
    choice: torch.Tensor, k: torch.Tensor,
    cfg: CodecConfig, coder: str, mesh: Sequence | None,
    backend: str | None = "auto",
) -> EncodedBlocks:
    """``encode.emit_blocks_body`` of each shard (one coder group, its
    selection given) -> :class:`EncodedBlocks` on ``mesh[0]``."""
    parts = _on_shards(
        lambda *t: encode.emit_blocks_body(*t, cfg, coder, backend), mesh,
        (x, n, history, choice, k))
    return EncodedBlocks(*_gather([r for _, r in parts], parts[0][0]))


def decode_blocks_sharded(
    payload: torch.Tensor,  # [B, Wp] int32 bit patterns
    k: torch.Tensor,
    n: torch.Tensor,
    predictor: torch.Tensor,
    table_idx: torch.Tensor,
    history: torch.Tensor,
    table_coeffs,           # [T, 4], replicated to every device
    block_len: int,
    has_lpc: bool,
    mesh: Sequence | None,
    backend: str | None = "auto",
    coder: str = "rice",
    max_planes: int = 32,
    buf_words: int = 0,
) -> torch.Tensor:
    """``decode.decode_blocks`` of each shard -> x [B, block_len] on
    ``mesh[0]``: every shard's kernels are launched before the first host
    read, K4's flags."""
    coeffs = decode.table_coeffs_i32(table_coeffs, "cpu")

    def one(*t):
        return decode.launch_decode_blocks(
            *t, coeffs.to(t[0].device), block_len, has_lpc, backend, coder,
            max_planes, buf_words)

    parts = _on_shards(one, mesh, (payload, k, n, predictor, table_idx, history))
    for _, (_, bad) in parts:
        if bad is not None:
            raise_if_bad_slots(bad)
    return _gather([(x,) for _, (x, _) in parts], parts[0][0])[0]
