"""The port's adaptive compress -> decompress slice vs the JAX reference.

Frames must be byte-identical to dctpu.codec.api.compress and to
scalar_compress, and each side must decode the other's frames. The
reference frames are computed once per block length (module fixture);
tests/test_torch_codec_ragged.py runs the same checks at block_len 300
(block_len % 128 != 0).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.codec import scalar
from dctpu.config import CodecConfig as RefConfig
from dctpu.config import LpcTable as RefLpcTable
from dctpu.corpus import synth_corpus
from dctpu.format import read_frame as ref_read_frame
from dctpu.format import write_frame as ref_write_frame
from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.kernels import (
    exc_extract,
    pack,
    reconstruct,
    rice_totals,
    select_bp,
    select_reduce,
    transpose,
    unpack,
    vdec,
    vemit,
)
from tests.conftest import stream_cases
from tests.test_adaptive import _mixed_streams

REPO = Path(__file__).resolve().parent.parent
INPUTS = ("mixed", "synth", "cases")


def _inputs():
    """name -> (streams, stream_ids, cadences)."""
    return {
        "mixed": (_mixed_streams(np.random.default_rng(1234)), None, None),
        "synth": synth_corpus(
            6, 3000, seed=21, mixed_cadence=True, cumulative_frac=0.4
        ),
        "cases": (
            stream_cases(np.random.default_rng(1234)) + [np.zeros(0, np.int32)],
            None, None,
        ),
    }


def frames(block_len, coder="adaptive", **fields):
    """name -> (streams, reference bytes, scalar bytes, port bytes)."""
    ref_cfg = RefConfig(block_len=block_len, coder=coder, **fields)
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    out = {}
    for name, (streams, ids, cads) in _inputs().items():
        out[name] = (
            streams,
            ref_write_frame(ref_api.compress(streams, ref_cfg, ids, cads)),
            ref_write_frame(scalar.scalar_compress(
                streams, ref_cfg, stream_ids=ids, cadences=cads
            )),
            write_frame(api.compress(streams, cfg, ids, cads, device="cpu")),
        )
    return out


def check_byte_identical(frames, name):
    _, ref_bytes, scalar_bytes, port_bytes = frames[name]
    assert port_bytes == ref_bytes
    assert port_bytes == scalar_bytes


def check_port_decodes_reference(frames, name):
    streams, ref_bytes, _, _ = frames[name]
    out = api.decompress(read_frame(ref_bytes), device="cpu")
    assert len(out) == len(streams)
    for a, b in zip(streams, out):
        assert b.dtype == np.int32
        assert np.array_equal(a, b)


def check_reference_decodes_port(frames, name):
    streams, _, _, port_bytes = frames[name]
    out = ref_api.decompress(ref_read_frame(port_bytes))
    assert len(out) == len(streams)
    for a, b in zip(streams, out):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def frames512():
    return frames(512)


@pytest.mark.parametrize("name", INPUTS)
def test_frames_byte_identical(frames512, name):
    check_byte_identical(frames512, name)


@pytest.mark.parametrize("name", INPUTS)
def test_port_decodes_reference_frames(frames512, name):
    check_port_decodes_reference(frames512, name)


@pytest.mark.parametrize("name", INPUTS)
def test_reference_decodes_port_frames(frames512, name):
    check_reference_decodes_port(frames512, name)


def test_both_coders_in_frames(frames512):
    for name in INPUTS:
        coders = read_frame(frames512[name][3]).blocks.coder_arr()
        assert set(np.unique(coders).tolist()) == {0, 1}, name


@pytest.mark.parametrize(
    "ref_cfg",
    [
        RefConfig(coder="adaptive"),
        RefConfig(
            block_len=300, predictors=(0, 2), k_max=20, coder="adaptive",
            lpc_tables=(
                RefLpcTable(order=1, coeffs=(65536, 0, 0, 0)),
                RefLpcTable(order=2, coeffs=(-7, 123456, 0, 0)),
            ),
        ),
    ],
)
def test_from_reference_reproduces_config(ref_cfg):
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    assert isinstance(cfg, CodecConfig)
    assert cfg.candidates() == ref_cfg.candidates()
    assert (cfg.block_len, cfg.k_max, cfg.coder) == (
        ref_cfg.block_len, ref_cfg.k_max, ref_cfg.coder
    )
    assert [(t.order, t.coeffs) for t in cfg.lpc_tables] == [
        (t.order, t.coeffs) for t in ref_cfg.lpc_tables
    ]
    pairs = {**dataclasses.asdict(ref_cfg),
             "lpc_tables": [(t.order, t.coeffs) for t in ref_cfg.lpc_tables]}
    assert from_reference(pairs) == cfg


def test_stage_times_and_config_checks():
    streams, _, _ = synth_corpus(2, 1500, seed=5)
    enc_ms, dec_ms = {}, {}
    cfg = CodecConfig(block_len=512, coder="adaptive")
    frame = api.compress(streams, cfg, device="cpu", stage_ms=enc_ms)
    out = api.decompress(read_frame(write_frame(frame)), device="cpu",
                         stage_ms=dec_ms)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert {"select", "interleave"} <= set(enc_ms)
    assert {"reconstruct", "download"} <= set(dec_ms)
    assert all(v >= 0 for v in [*enc_ms.values(), *dec_ms.values()])
    with pytest.raises(ValueError, match="unknown coder"):
        api.compress(streams, CodecConfig(coder="huffman"), device="cpu")
    with pytest.raises(ValueError, match="k_max"):
        api.compress(streams, CodecConfig(coder="rice", k_max=25), device="cpu")


def test_empty_input_round_trip():
    for streams in ([], [np.zeros(0, np.int32)]):
        frame = api.compress(streams, CodecConfig(coder="adaptive"), device="cpu")
        data = write_frame(frame)
        assert data == ref_write_frame(scalar.scalar_compress(
            streams, RefConfig(coder="adaptive")
        ))
        out = api.decompress(read_frame(data), device="cpu")
        assert [o.size for o in out] == [0] * len(streams)


def _mutated(frame, **cols):
    blocks = dataclasses.replace(
        frame.blocks, **{k: v.copy() for k, v in vars(frame.blocks).items()}
    )
    out = dataclasses.replace(frame, blocks=blocks,
                              payload_words=frame.payload_words.copy())
    for name, (i, value) in cols.items():
        if name == "payload_words":
            out.payload_words[i] = value
        else:
            getattr(out.blocks, name)[i] = value
    return out


def test_decompress_rejects_malformed_block_tables():
    frame = api.compress(stream_cases(np.random.default_rng(1234)),
                         CodecConfig(block_len=512, coder="adaptive"),
                         device="cpu")
    hb = frame.blocks
    lpc = int(np.nonzero(hb.predictor == 2)[0][0])
    rice = int(np.nonzero(hb.coder == 0)[0][0])
    vert = int(np.nonzero(hb.coder == 1)[0][0])
    vert_sync = int(hb.word_offsets(512)[vert])
    bad = [
        _mutated(frame, coder=(0, 7)),
        _mutated(frame, predictor=(0, 3)),
        _mutated(frame, table_idx=(lpc, len(frame.tables))),
        _mutated(frame, n=(0, 513)),
        _mutated(frame, bit_len=(rice, 10**6)),
        _mutated(frame, k=(rice, 31)),
        _mutated(frame, payload_words=(vert_sync, 40)),  # sub 0: b = 40
    ]
    for f in bad:
        with pytest.raises(ValueError, match="malformed|sync table"):
            api.decompress(f, device="cpu")


def test_wrappers_refuse_other_devices():
    """A wrapper runs its twin only for CPU tensors and never falls back."""
    z = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    h = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    words = torch.zeros(64, dtype=torch.int32, device="meta")
    calls = [
        lambda: select_bp.adaptive_totals_bp(z, n, 256, 24),
        lambda: select_bp.adaptive_totals_xbp(z, h, n, 256, 24),
        lambda: vemit.vertical_emit_rows_z(z, n, 256),
        lambda: vemit.vertical_emit_rows(z, h, n, n, CodecConfig(block_len=256)),
        lambda: reconstruct.reconstruct(z, n, n, n, h, h),
        lambda: vdec.decode_vertical_words(words, n, n, n, 256),
        lambda: rice_totals.rice_totals(z, n, 256, 24),
        lambda: rice_totals.rice_totals_xbp(z, h, n, 256, 24),
        lambda: rice_totals.rice_totals_lpc(z, h, n, (1, 2, 3, 4), 256, 24),
        lambda: pack.rice_pack(z, n, n, 256),
        lambda: pack.rice_pack_rows(z, h, n, n, n, CodecConfig(block_len=256)),
        lambda: unpack.rice_unpack_words(words, n, n, n, n, 256),
        lambda: select_reduce.adaptive_totals_reduce(z, n, 256, 24),
        lambda: exc_extract.exc_extract(z.reshape(2, 2, 128), n.reshape(2, 1)),
        lambda: transpose.bit_planes32(z.reshape(4, 128)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "from dctpu_torch.codec import compress, decompress\n"
        "import dctpu_torch.kernels.vemit, dctpu_torch.kernels.pack\n"
        "import dctpu_torch.kernels.vertical_cost\n"
        "from dctpu_torch import (BLOCK_LEN_DEFAULT, DELTA, DOUBLE_DELTA,\n"
        "    ESCAPE_Q, K_MAX, LPC, MAX_CODE_BITS, RAW_BITS)\n"
        "import dctpu_torch.codec.api, dctpu_torch.kernels.vdec, chip_smoke\n"
        "import dctpu_torch.cli.main, dctpu_torch.codec.select\n"
        "import dctpu_torch.kernels.select_reduce, dctpu_torch.kernels.exc_extract\n"
        "import dctpu_torch.kernels.transpose, dctpu_torch.kernels.reconstruct\n"
        "import dctpu_torch.dist, dctpu_torch.dist.multihost, dctpu_torch.utils\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dctpu' or m.startswith('dctpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_package_names_match_the_reference():
    """The package-level names of dctpu and dctpu.codec that the port has:
    the format constants, and compress and decompress, which load lazily."""
    import dctpu
    import dctpu.codec
    import dctpu_torch
    import dctpu_torch.codec

    for name in ("BLOCK_LEN_DEFAULT", "DELTA", "DOUBLE_DELTA", "ESCAPE_Q",
                 "K_MAX", "LPC", "MAX_CODE_BITS", "RAW_BITS"):
        assert getattr(dctpu_torch, name) == getattr(dctpu, name), name
    for name in ("compress", "decompress"):
        assert callable(getattr(dctpu.codec, name))
        assert getattr(dctpu_torch.codec, name) is getattr(api, name)
        assert name in dir(dctpu_torch.codec)
    with pytest.raises(AttributeError):
        dctpu_torch.codec.scalar_compress  # noqa: B018 (not ported)


def test_decode_range_matches_reference_decode(frames512):
    """decode_range on the CPU, over ranges that hold both coder groups, the
    whole batch and an empty range, equals the reference's decoded blocks."""
    ref_bytes = frames512["mixed"][1]
    want = ref_api._decode_blocks_array(ref_read_frame(ref_bytes))
    frame = read_frame(ref_bytes)
    B, L = frame.blocks.num_blocks, frame.block_len
    off_h = frame.blocks.word_offsets(L)
    coeffs = torch.tensor([list(t.coeffs) for t in frame.tables] or [[0] * 4],
                          dtype=torch.int32)
    coders = frame.blocks.coder_arr()
    switch = int(np.nonzero(coders[1:] != coders[:-1])[0][-1])  # last change
    for b0, b1 in ((0, B), (1, B - 2), (switch, switch + 2), (4, 4)):
        assert b0 == b1 or set(coders[b0:b1].tolist()) == {0, 1}
        xs, bad = api.decode_range(frame, off_h, coeffs, b0, b1)
        assert bad is None and xs.dtype == torch.int32
        assert np.array_equal(xs.numpy(), want[b0:b1])


def test_range_blocks_bounds_the_default_pass():
    """The default pass: one range on the CPU (no total memory); on a card,
    ranges of as many blocks as fit 1 / DEVICE_SHARE of its total memory at
    DEVICE_BYTES_PER_SAMPLE bytes a sample; an explicit chunk_blocks wins."""
    per_block = api.DEVICE_SHARE * api.DEVICE_BYTES_PER_SAMPLE
    assert api.range_blocks(None, None, 4096) is None
    assert api.device_memory(["cpu"]) is None
    assert api.device_memory([torch.device("cpu"), "cuda:0"]) is None
    h100 = 85_017_493_504  # an H100 80GB HBM3's total_memory
    got = api.range_blocks(None, h100, 4096)
    assert got == h100 // (per_block * 4096)
    assert got >= 8192  # 128 MiB at 4096 samples a block is one range
    assert api.range_blocks(None, h100, 128) == h100 // (per_block * 128)
    assert api.range_blocks(None, 1, 4096) == 1
    assert api.range_blocks(None, 3 * per_block * 100, 100) == 3
    for total in (None, 1, h100):
        assert api.range_blocks(7, total, 4096) == 7
    assert len(api.block_ranges(1000, api.range_blocks(
        None, 3 * per_block * 128 + 5, 128))) == 334
