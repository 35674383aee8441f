"""The port's encode ``backend`` argument vs the JAX reference.

"auto", "pallas" and "xla" give the frame of the reference's default
backend, for each coder; the reference's other packer names ("scan",
"merge", "scatter") take the port's default path; the staged VERTICAL
emission of backend="pallas" gives the reference's payload rows; and
"reduce", "bp" or an unknown name raise ValueError where the reference
raises: at the emission of a RICE group. Integer codec: exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.codec.encode import encode_blocks as ref_encode_blocks
from dctpu.config import CodecConfig as RefConfig
from dctpu.format import write_frame as ref_write_frame
from dctpu.kernels import api as ref_kernels
from dctpu_torch.codec import api, encode
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format import read_frame, write_frame
from tests.conftest import stream_cases
from tests.test_adaptive import _mixed_streams

CODERS = ("adaptive", "rice", "vertical")
PACKER_NAMES = ("auto", "pallas", "xla")
ALIAS_NAMES = ("scan", "merge", "scatter")  # XLA packers; the port has K5a
UNKNOWN_NAMES = ("reduce", "bp", "no_such_backend")


def _streams():
    streams = _mixed_streams(np.random.default_rng(1234))
    return streams + synth_corpus(2, 3000, seed=5, cumulative_frac=0.5)[0]


def _cfgs(coder):
    ref_cfg = RefConfig(block_len=512, coder=coder)
    return ref_cfg, from_reference(dataclasses.asdict(ref_cfg))


@pytest.fixture(scope="module")
def ref_frames():
    """coder -> the reference's frame with its default backend."""
    streams = _streams()
    return {
        coder: ref_write_frame(ref_api.compress(streams, _cfgs(coder)[0]))
        for coder in CODERS
    }


@pytest.mark.parametrize("backend", PACKER_NAMES)
@pytest.mark.parametrize("coder", CODERS)
def test_backend_frames_equal_reference(ref_frames, coder, backend):
    got = write_frame(
        api.compress(_streams(), _cfgs(coder)[1], device="cpu", backend=backend)
    )
    assert got == ref_frames[coder]
    if coder == "adaptive":
        coders = read_frame(got).blocks.coder_arr()
        assert set(np.unique(coders).tolist()) == {0, 1}


@pytest.mark.parametrize("alias", ALIAS_NAMES)
@pytest.mark.parametrize("coder", CODERS)
def test_packer_aliases_take_the_default_path(coder, alias):
    """Selection and the emission of either coder group under the
    reference's other packer names equal the default path's."""
    cfg = _cfgs(coder)[1]
    streams = synth_corpus(2, 1500, seed=9, cumulative_frac=0.5)[0]
    x, n, h, _, _ = api.build_blocks(streams, cfg.block_len)
    t = [torch.from_numpy(a) for a in (x, n, h)]
    select = encode.adaptive_select if coder == "adaptive" else encode.select_blocks
    want = select(*t, cfg)
    for g, w in zip(select(*t, cfg, backend=alias), want):
        assert torch.equal(g, w)
    choice, k = want[0], want[-1]
    for group in ("rice", "vertical"):
        for g, w in zip(encode.emit_blocks(*t, choice, k, cfg, group, alias),
                        encode.emit_blocks(*t, choice, k, cfg, group)):
            assert torch.equal(g, w)


def test_vertical_pallas_payload_matches_reference(rng):
    """The reference's test_encode_backend_pallas_payload_identical, held
    against the port's staged emission (K9, the width rule, K8)."""
    streams = stream_cases(rng)
    ref_cfg = RefConfig(coder="vertical")
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    x, n, h, _, _ = ref_api.build_blocks(streams, ref_cfg.block_len)
    want = ref_encode_blocks(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "pallas"
    )
    t = [torch.from_numpy(a) for a in (x, n, h)]
    choice, k = encode.select_blocks(*t, cfg, backend="pallas")
    payload, bit_len = encode.emit_blocks(*t, choice, k, cfg, "vertical", "pallas")
    assert np.array_equal(payload.numpy().view(np.uint32), np.asarray(want.payload))
    assert np.array_equal(bit_len.numpy(), np.asarray(want.bit_len))
    mega = encode.emit_blocks(*t, choice, k, cfg, "vertical")
    assert torch.equal(payload, mega[0]) and torch.equal(bit_len, mega[1])


@pytest.mark.parametrize("backend", UNKNOWN_NAMES)
def test_unknown_backends_raise_where_reference_does(ref_frames, backend):
    streams = _streams()
    # the reference raises in its RICE packer, and so in a rice compress
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ref_kernels.pack(None, None, None, None, 512, backend)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ref_api.compress(streams, _cfgs("rice")[0], backend=backend)
    for coder in ("adaptive", "rice"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            api.compress(streams, _cfgs(coder)[1], device="cpu", backend=backend)
    # no RICE group: the frame is the default one
    got = api.compress(streams, _cfgs("vertical")[1], device="cpu", backend=backend)
    assert write_frame(got) == ref_frames["vertical"]
    # adaptive selection itself runs under every name
    cfg = _cfgs("adaptive")[1]
    x, n, h, _, _ = api.build_blocks(streams, 512)
    t = [torch.from_numpy(a) for a in (x, n, h)]
    for g, w in zip(encode.adaptive_select(*t, cfg, backend=backend),
                    encode.adaptive_select(*t, cfg)):
        assert torch.equal(g, w)


def test_emit_rejects_unknown_backend_before_work():
    cfg = CodecConfig(block_len=256)
    z = torch.zeros((1, 256), dtype=torch.int32)
    n = torch.full((1,), 256, dtype=torch.int32)
    h = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="'bp'"):
        encode.emit_blocks(z, n, h, n * 0, n * 0, cfg, "rice", "bp")
    payload, _ = encode.emit_blocks(z, n, h, n * 0, n * 0, cfg, "vertical", "bp")
    assert payload.shape[0] == 1
