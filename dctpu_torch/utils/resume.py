"""Checkpoint/resume for long encode jobs (a copy of ``dctpu/utils/resume.py``
over the port's ``compress``).

Resumability is at stream granularity, first-class in the DCF1 frame:
every block decodes on its own. A job writes one part frame per call plus a
manifest of the finished parts; on restart, finished parts are skipped, and
``merge`` concatenates the parts into the final frame.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig
from dctpu_torch.format.frame import (
    BlockHeaders,
    Frame,
    StreamDir,
    read_frame,
    write_frame,
)


def with_retry(fn, attempts: int = 2, on_error=None):
    """Calls fn() up to ``attempts`` times; returns its first result, or
    raises the last error. ``on_error(i, e)`` sees each failure.

    Any stream shard re-encodes on its own, so recovering from a failed
    part is retrying it: there is no shared state to repair."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- deliberate blanket retry
            last = e
            if on_error is not None:
                on_error(i, e)
    raise last


class EncodeJob:
    """Resumable chunked encode: streams -> part frames -> one merged frame,
    each part encoded on ``device``."""

    def __init__(self, workdir: str | Path, cfg: CodecConfig | None = None,
                 device="cuda"):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg or CodecConfig()
        self.device = device
        self.manifest_path = self.workdir / "manifest.json"
        self.manifest: Dict[str, str] = {}
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())

    def done(self, part_id: str) -> bool:
        return part_id in self.manifest

    def encode_part(
        self,
        part_id: str,
        streams: Sequence[np.ndarray],
        stream_ids: Sequence[int] | None = None,
        cadences: Sequence[int] | None = None,
        attempts: int = 2,
    ) -> Path:
        """Encodes one part, unless the manifest has it; the encode is
        tried ``attempts`` times (:func:`with_retry`). The part file and the
        manifest are each replaced atomically: a part is either absent or
        complete."""
        path = self.workdir / f"part-{part_id}.dcf"
        if self.done(part_id) and path.exists():
            return path
        frame = with_retry(
            lambda: api.compress(streams, self.cfg, stream_ids, cadences,
                                 device=self.device),
            attempts=attempts,
        )
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(write_frame(frame))
        os.replace(tmp, path)
        self.manifest[part_id] = path.name
        tmp_manifest = self.manifest_path.with_suffix(".tmp")
        tmp_manifest.write_text(json.dumps(self.manifest, indent=0))
        os.replace(tmp_manifest, self.manifest_path)
        return path

    def merge(self, out_path: str | Path) -> Path:
        """Concatenates the finished parts into one frame (stream order =
        part insertion order, then within-part order), directory columns and
        block table whole, with no per-stream work."""
        frames = [
            read_frame((self.workdir / name).read_bytes())
            for name in self.manifest.values()
        ]
        if not frames:
            raise ValueError("no completed parts to merge")
        L = frames[0].block_len
        tables = frames[0].tables
        for f in frames:
            if f.block_len != L or f.tables != tables:
                raise ValueError("parts disagree on block_len/tables")

        base = np.cumsum([0] + [f.blocks.num_blocks for f in frames[:-1]])

        def col(field):
            return np.concatenate([getattr(f.streams, field) for f in frames])

        streams = StreamDir(
            stream_id=col("stream_id"),
            cadence_s=col("cadence_s"),
            num_samples=col("num_samples"),
            num_blocks=col("num_blocks"),
            first_block=np.concatenate([
                f.streams.first_block.astype(np.int64) + b
                for f, b in zip(frames, base)
            ]),
        )

        def cat(field):
            return np.concatenate([getattr(f.blocks, field) for f in frames])

        blocks = BlockHeaders(
            predictor=cat("predictor"),
            k=cat("k"),
            n=cat("n"),
            bit_len=cat("bit_len"),
            table_idx=cat("table_idx"),
            history=cat("history"),
            coder=np.concatenate([f.blocks.coder_arr() for f in frames]),
        )
        merged = Frame(
            block_len=L,
            streams=streams,
            blocks=blocks,
            tables=tables,
            payload_words=np.concatenate([f.payload_words for f in frames]),
        )
        out_path = Path(out_path)
        out_path.write_bytes(write_frame(merged))
        return out_path
