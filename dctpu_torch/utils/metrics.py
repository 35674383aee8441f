"""Structured per-run metrics (a copy of ``dctpu/utils/metrics.py``).

One JSON object per run: bytes in and out, ratio, throughput, the
predictor and coder histograms, and the devices and processes used.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np

from dctpu_torch.constants import CODER_RICE, CODER_VERTICAL
from dctpu_torch.format.frame import StreamDir


@dataclasses.dataclass
class RunMetrics:
    mode: str = ""                  # encode | decode | verify
    raw_bytes: int = 0
    compressed_bytes: int = 0
    wall_seconds: float = 0.0
    num_streams: int = 0
    num_blocks: int = 0
    predictor_histogram: Optional[Dict[str, int]] = None
    coder_histogram: Optional[Dict[str, int]] = None
    num_devices: int = 1
    num_processes: int = 1
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def ratio(self) -> float:
        return self.raw_bytes / self.compressed_bytes if self.compressed_bytes else 0.0

    @property
    def gbps(self) -> float:
        return self.raw_bytes / self.wall_seconds / 1e9 if self.wall_seconds else 0.0

    @staticmethod
    def from_frame(frame, mode: str, wall_seconds: float, compressed_bytes: int):
        pred_names = {0: "delta", 1: "double_delta", 2: "lpc"}
        coder_names = {CODER_RICE: "rice", CODER_VERTICAL: "vertical"}
        preds = frame.blocks.predictor
        coders = frame.blocks.coder_arr()
        if isinstance(frame.streams, StreamDir):
            samples = int(frame.streams.num_samples.sum())
        else:
            samples = sum(s.num_samples for s in frame.streams)
        return RunMetrics(
            mode=mode,
            raw_bytes=samples * 4,
            compressed_bytes=compressed_bytes,
            wall_seconds=wall_seconds,
            num_streams=len(frame.streams),
            num_blocks=frame.blocks.num_blocks,
            predictor_histogram={
                name: int(np.sum(preds == pid)) for pid, name in pred_names.items()
            },
            coder_histogram={
                name: int(np.sum(coders == cid)) for cid, name in coder_names.items()
            },
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        d["gbps"] = self.gbps
        return json.dumps(d)
