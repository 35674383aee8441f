"""The port's coder="rice" and coder="vertical" paths at block_len 300,
a predictor subset, k_max 24 and the default config, vs the reference.

300 % 128 != 0: the last sub-block of each block is short, which the RICE
packer and unpacker (K5a, K5b) and the VERTICAL kernels (K3, K4) must
cover on the card. Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

from dctpu.codec import api as ref_api
from dctpu.config import CodecConfig as RefConfig
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.constants import DELTA
from dctpu_torch.format import read_frame, write_frame
from tests.test_torch_codec import (
    INPUTS,
    _inputs,
    check_byte_identical,
    check_port_decodes_reference,
    check_reference_decodes_port,
    frames,
)


CODERS = ("rice", "vertical")


@pytest.fixture(scope="module", params=CODERS)
def coder_frames300(request):
    return frames(300, request.param)


@pytest.mark.parametrize("name", INPUTS)
def test_frames_byte_identical(coder_frames300, name):
    check_byte_identical(coder_frames300, name)


@pytest.mark.parametrize("name", INPUTS)
def test_port_decodes_reference_frames(coder_frames300, name):
    check_port_decodes_reference(coder_frames300, name)


@pytest.mark.parametrize("name", INPUTS)
def test_reference_decodes_port_frames(coder_frames300, name):
    check_reference_decodes_port(coder_frames300, name)


@pytest.mark.parametrize("coder", CODERS)
def test_predictor_subset_and_k_max(coder):
    """predictors=(DELTA,), and k_max 24 explicitly, the largest the
    reference's RICE coder takes."""
    streams, ids, cads = _inputs()["synth"]
    for fields in ({"predictors": (DELTA,)}, {"k_max": 24}):
        ref_cfg = RefConfig(block_len=512, coder=coder, **fields)
        cfg = from_reference(dataclasses.asdict(ref_cfg))
        want = ref_write_frame(ref_api.compress(streams, ref_cfg, ids, cads))
        got = write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))
        assert got == want, fields
        out = api.decompress(read_frame(got), device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(streams, out))


def test_default_config_matches_reference():
    """compress(streams) without a config is the reference's CodecConfig():
    coder "rice" at block_len 4096."""
    streams, _, _ = _inputs()["synth"]
    assert CodecConfig().coder == RefConfig().coder == "rice"
    got = write_frame(api.compress(streams, device="cpu"))
    assert got == ref_write_frame(ref_api.compress(streams))
