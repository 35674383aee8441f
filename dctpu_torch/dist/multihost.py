"""Several processes, each encoding its own streams; process 0 assembles
the frame. The counterpart of ``dctpu/dist/multihost.py``, on
``torch.distributed`` with the gloo backend.

The reference's collectives move host numpy arrays
(``multihost_utils.process_allgather``): block metadata, bit lengths and
the compact payload words are all on the host, so gloo, which moves CPU
tensors, carries them here too (NCCL would also need one GPU per
process). Each process encodes on its own device, by default
``cuda:{rank % device_count}``; on the CPU only when the caller passes
``device="cpu"``. The steps are the reference's:

  1. every process allgathers its block count, pads its blocks to the
     largest (rounded to its local device count, which is 1 here: a
     process encodes on one device), encodes them, and allgathers each
     block's predictor, k, table index, bit length, n and history;
  2. the compact payload words reach process 0 by a padded allgather
     (``"allgather"``) or as one part file per process in ``parts_dir``,
     each written with an atomic rename, then a barrier (``"files"``);
     ``"auto"`` is ``"files"`` when ``parts_dir`` is given;
  3. the stream metadata is allgathered and process 0 assembles the frame:
     global stream order is process order, then each process's order.

Every collective runs on every process: one that a process skipped would
leave the others waiting. Like the reference, the encode runs the
single-coder path, RICE for every coder but "vertical": a config with
coder="adaptive" gives the all-RICE frame of coder="rice" (the reference's
``encode_blocks_body`` takes its rice branch for "adaptive").
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.constants import CODER_RICE, CODER_VERTICAL
from dctpu_torch.format.frame import (
    BlockHeaders,
    Frame,
    StreamDir,
    payload_word_counts,
)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Joins the gloo process group at ``tcp://coordinator_address``
    (``env://`` when it is None); does nothing when the group exists."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo",
        init_method=(
            f"tcp://{coordinator_address}" if coordinator_address else "env://"
        ),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def _allgather(a: np.ndarray) -> np.ndarray:
    """[nproc, *a.shape]: every process's a (one shape and dtype on all)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def compress_multihost(
    local_streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    local_stream_ids: Sequence[int] | None = None,
    local_cadences: Sequence[int] | None = None,
    backend: str = "xla",
    gather: str = "auto",
    parts_dir: str | None = None,
    device=None,
):
    """Each process passes its own streams; returns (frame or None, stats).

    Process 0 returns the assembled Frame, byte-identical to a
    single-process ``compress`` of all processes' streams in order (with
    coder="rice" for every coder but "vertical"); the others return None.
    stats: {"global_blocks": processes x padded blocks per process,
    "local_blocks": this process's blocks, "compressed_words": the compact
    words of all processes, padding blocks included}."""
    cfg = cfg or CodecConfig()
    if gather == "auto":
        gather = "files" if parts_dir is not None else "allgather"
    if gather not in ("files", "allgather"):
        raise ValueError(f"unknown gather mode {gather!r}")
    if gather == "files" and parts_dir is None:
        raise ValueError("gather='files' needs parts_dir")
    nproc, pid = dist.get_world_size(), dist.get_rank()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("compress_multihost: no CUDA device; pass device")
        device = torch.device("cuda", pid % torch.cuda.device_count())
    enc_cfg = cfg if cfg.coder == "vertical" else dataclasses.replace(cfg, coder="rice")

    L = cfg.block_len
    x, n, hist, nb, first = api.build_blocks(local_streams, L)
    B_local = x.shape[0]
    per_proc = max(int(_allgather(np.array([B_local], np.int64)).max()), 1)
    xg, ng, hg = (_pad_rows(a, per_proc) for a in (x, n, hist))
    choice, _, k, bit_len, local_compact = api.encode_range(
        xg, ng, hg, enc_cfg, device, backend
    )
    pred_map, ti_map = api.candidate_maps(cfg)
    blocks_g = _allgather(np.column_stack(
        [pred_map[choice], k, ti_map[choice], bit_len, ng, hg]
    ).astype(np.int64))  # [nproc, per_proc, 9]: pred, k, ti, bit_len, n, history

    sizes = _allgather(np.array([local_compact.size], np.int64)).reshape(-1)
    if gather == "files":
        # each process writes only its own ordered part; the atomic rename
        # and the barrier make process 0's reads race-free
        pdir = Path(parts_dir)
        pdir.mkdir(parents=True, exist_ok=True)
        part = pdir / f"payload-{pid:05d}.u32"
        tmp = part.with_suffix(".tmp")
        tmp.write_bytes(np.ascontiguousarray(local_compact, "<u4").tobytes())
        os.replace(tmp, part)
        dist.barrier()

        def proc_payload(p: int) -> np.ndarray:
            data = (pdir / f"payload-{p:05d}.u32").read_bytes()
            return np.frombuffer(data, dtype="<u4")
    else:
        padded = np.zeros(max(int(sizes.max()), 1), np.uint32)
        padded[: local_compact.size] = local_compact
        gathered = _allgather(padded.view(np.int32)).view(np.uint32)

        def proc_payload(p: int) -> np.ndarray:
            return gathered[p]

    S = len(local_streams)
    local_meta = np.column_stack([
        np.asarray(local_stream_ids, np.uint64).astype(np.int64)
        if local_stream_ids is not None else np.arange(S, dtype=np.int64),
        np.asarray(local_cadences, np.int64)
        if local_cadences is not None else np.full(S, 900, np.int64),
        np.fromiter((np.asarray(s).size for s in local_streams), np.int64, S),
        nb, first,
    ]).reshape(S, 5)
    nstreams = _allgather(np.array([S], np.int64)).reshape(-1)
    metas_g = _allgather(_pad_rows(local_meta, max(int(nstreams.max()), 1)))

    stats = {
        "global_blocks": int(nproc * per_proc),
        "local_blocks": B_local,
        "compressed_words": int(sizes.sum()),
    }
    if pid != 0:
        return None, stats

    metas = np.concatenate([metas_g[p, : nstreams[p]] for p in range(nproc)])
    p_blocks = [int(metas_g[p, : nstreams[p], 3].sum()) for p in range(nproc)]
    rows = np.concatenate([blocks_g[p, : p_blocks[p]] for p in range(nproc)])
    payload = np.concatenate([
        proc_payload(p)[: int(payload_word_counts(blocks_g[p, : p_blocks[p], 3], L).sum())]
        for p in range(nproc)
    ])
    base = np.cumsum([0] + p_blocks[:-1])
    coder_id = CODER_VERTICAL if cfg.coder == "vertical" else CODER_RICE
    blocks = BlockHeaders(
        predictor=rows[:, 0].astype(np.uint8),
        k=rows[:, 1].astype(np.uint8),
        n=rows[:, 4].astype(np.uint16),
        bit_len=rows[:, 3].astype(np.uint32),
        table_idx=rows[:, 2].astype(np.uint8),
        history=np.ascontiguousarray(rows[:, 5:], dtype=np.int32),
        coder=np.full(rows.shape[0], coder_id, dtype=np.uint8),
    )
    streams = StreamDir(
        stream_id=metas[:, 0].astype(np.uint64),
        cadence_s=metas[:, 1],
        num_samples=metas[:, 2],
        num_blocks=metas[:, 3],
        first_block=metas[:, 4] + np.repeat(base, nstreams),
    )
    frame = Frame(
        block_len=L,
        streams=streams,
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=payload.astype(np.uint32),
    )
    return frame, stats
