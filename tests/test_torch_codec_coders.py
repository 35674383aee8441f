"""The port's coder="rice" and coder="vertical" paths vs the JAX reference.

As tests/test_torch_codec.py does for the adaptive coder: frames must be
byte-identical to dctpu.codec.api.compress and to scalar_compress, and
each side must decode the other's frames. The reference frames are
computed once per coder (module fixture); tests/test_torch_codec_coders_
ragged.py runs the same checks at block_len 300, and the predictor-subset,
k_max and default-config checks. Tolerance: exact.
"""

import numpy as np
import pytest

from dctpu_torch.format import read_frame
from tests.test_torch_codec import (
    INPUTS,
    check_byte_identical,
    check_port_decodes_reference,
    check_reference_decodes_port,
    frames,
)

CODERS = ("rice", "vertical")


@pytest.fixture(scope="module", params=CODERS)
def coder_frames(request):
    return frames(512, request.param)


@pytest.mark.parametrize("name", INPUTS)
def test_frames_byte_identical(coder_frames, name):
    check_byte_identical(coder_frames, name)


@pytest.mark.parametrize("name", INPUTS)
def test_port_decodes_reference_frames(coder_frames, name):
    check_port_decodes_reference(coder_frames, name)


@pytest.mark.parametrize("name", INPUTS)
def test_reference_decodes_port_frames(coder_frames, name):
    check_reference_decodes_port(coder_frames, name)


def test_single_coder_frames(coder_frames):
    for name in INPUTS:
        blocks = read_frame(coder_frames[name][3]).blocks
        assert np.unique(blocks.coder_arr()).size == 1, name
        if blocks.coder_arr()[0] == 1:
            assert not blocks.k.any(), name
