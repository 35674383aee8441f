"""The port's compression-ratio floors: the counterpart of
tests/test_perf_floors.py for dctpu_torch, on the CPU.

The ratio is a function of the bitstream alone, so the reference's floors
(bench/floors.json ``frame_ratio_floor``, on its ``ratio_corpus``) hold
for the port's frames on any device. Its ``tpu_gbps_floor`` holds TPU
rates and is not read.
"""

import json
from pathlib import Path

import pytest

from dctpu_torch.codec.api import compress
from dctpu_torch.config import CodecConfig
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format import write_frame

FLOORS = json.loads(
    (Path(__file__).resolve().parents[1] / "bench" / "floors.json").read_text()
)
CODERS = ("rice", "vertical", "adaptive")


@pytest.fixture(scope="module")
def frames():
    g = FLOORS["ratio_corpus"]
    streams, _, _ = synth_corpus(
        g["streams"], g["samples"], seed=g["seed"],
        mixed_cadence=g["mixed_cadence"], cumulative_frac=g["cumulative_frac"],
    )
    raw = sum(s.nbytes for s in streams)
    return raw, {coder: compress(streams, CodecConfig(coder=coder), device="cpu")
                 for coder in CODERS}


@pytest.mark.parametrize("coder", CODERS)
def test_port_frame_ratio_floor(frames, coder):
    raw, by_coder = frames
    ratio = raw / len(write_frame(by_coder[coder]))
    floor = FLOORS["frame_ratio_floor"][coder]
    assert ratio >= floor, f"{coder} ratio {ratio:.3f} < floor {floor}"


def test_port_adaptive_dominates(frames):
    """FORMAT §4.1: adaptive picks the cheaper coder per block, so its
    payload is never larger than either uniform coder's."""
    _, by_coder = frames
    sizes = {c: f.payload_words.nbytes for c, f in by_coder.items()}
    assert sizes["adaptive"] <= sizes["rice"]
    assert sizes["adaptive"] <= sizes["vertical"]
