"""The CUDA kernels K1-K6 against their plain twins, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU (sm_90a, with nvcc) and
skip without one; ``python3 chip_smoke.py`` runs the same comparisons at
the bench geometry. They import no jax, so they also run where jax is
missing, without tests/conftest.py (which imports it):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from dctpu_torch.codec import api
from dctpu_torch.config import CodecConfig, LpcTable
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.kernels import pack, rice_totals, select_bp, unpack, vdec, vemit
from dctpu_torch.kernels.vertical import assemble_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(L, seed, B=40):
    rng = np.random.default_rng(seed)
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF
    z[1] = 0
    z[4, :16] = (1 << rng.integers(20, 31, size=16)).astype(np.uint32)
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[0, :9] = np.int32(-(2**31))
    h = rng.integers(-(2**28), 2**28, size=(B, 4)).astype(np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)
    n[-2] = 0
    n[3] = min(L, 128)
    k = (np.arange(B) % 28).astype(np.int32)
    return (torch.from_numpy(a) for a in (z.view(np.int32), x, h, n, k))


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("L", [4096, 300, 100, 129])
def test_kernels_match_twins_on_card(cuda, L):
    z, x, h, n, _ = (t.to(cuda) for t in _inputs(L, 7))
    _same(select_bp.adaptive_totals_xbp(x, h, n, L, 24),
          select_bp.adaptive_totals_xbp_plain(x, h, n, L, 24))
    _same(select_bp.adaptive_totals_bp(z, n, L, 24),
          select_bp.adaptive_totals_bp_plain(z, n, L, 24))
    emitted = vemit.vertical_emit(z, n, L)
    _same(emitted, vemit.vertical_emit_plain(z, n, L))
    planes, b, _, n_exc, e, pos_words, vals = emitted
    rows = assemble_rows(planes, b, n_exc, e, pos_words, vals, L)
    _same((vdec.decode_vertical(rows, n, L),),
          (vdec.decode_vertical_plain(rows, n, L),))


@pytest.mark.parametrize("L", [4096, 300, 100, 129, 12000])
def test_rice_kernels_match_twins_on_card(cuda, L):
    """K6, K5a and K5b; 12000 takes K5a's device-memory row path."""
    z, _, _, n, k = (t.to(cuda) for t in _inputs(L, 9))
    _same((rice_totals.rice_totals(z, n, L, 24),),
          (rice_totals.rice_totals_plain(z, n, L, 24),))
    packed = pack.rice_pack(z, k, n, L)
    _same(packed, pack.rice_pack_plain(z, k, n, L))
    rows = torch.nn.functional.pad(packed[0], (0, 2))
    _same((unpack.rice_unpack(rows, k, n, L),), (unpack.unpack(rows, k, n, L),))


CONFIGS = {
    "default": CodecConfig(coder="adaptive"),
    "L1000": CodecConfig(block_len=1000, coder="adaptive"),
    "L100_k27": CodecConfig(block_len=100, k_max=27, coder="adaptive"),
    "odd_tables": CodecConfig(
        block_len=384, predictors=(0, 2), coder="adaptive",
        lpc_tables=(
            LpcTable(1, (65536, 0, 0, 0)),
            LpcTable(4, (2**31 - 1, -(2**31), 2**30, -5)),
        ),
    ),
    "rice": CodecConfig(),
    "rice_L300_delta": CodecConfig(block_len=300, predictors=(0,), coder="rice"),
    "vertical": CodecConfig(coder="vertical"),
    "vertical_L1000": CodecConfig(block_len=1000, coder="vertical"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_card_frames_equal_cpu_frames(cuda, name):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(11)
    streams, ids, cads = synth_corpus(4, 9000, seed=3, mixed_cadence=True,
                                      cumulative_frac=0.5)
    streams += [
        rng.integers(-(2**31), 2**31, size=700, dtype=np.int64).astype(np.int32),
        np.zeros(0, np.int32),
    ]
    ids, cads = ids + [4, 5], cads + [900, 900]
    on_card = write_frame(api.compress(streams, cfg, ids, cads, device=cuda))
    assert on_card == write_frame(api.compress(streams, cfg, ids, cads, device="cpu"))
    out = api.decompress(read_frame(on_card), device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
