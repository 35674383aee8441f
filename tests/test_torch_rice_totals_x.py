"""K6's x forms (``rice_totals_xbp``, ``rice_totals_lpc``) and the rice
selection that runs them, vs the JAX reference.

The reference Pallas kernel (``rice_totals_pallas``) runs in interpret mode
on the CPU, on the reference's own candidate residuals
(``dctpu.codec.predict`` + ``zigzag``); the reference rice selection is
``encode_blocks_body``'s in its portable formulation (backend="xla").
Integer codec: every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import encode as ref_encode
from dctpu.codec import predict as ref_predict
from dctpu.codec import rice as ref_rice
from dctpu.config import CodecConfig as RefConfig
from dctpu.constants import DELTA, DOUBLE_DELTA, LPC
from dctpu.kernels.select_pallas import rice_totals_pallas
from dctpu_torch.codec import api, encode
from dctpu_torch.config import DEFAULT_LPC_TABLES, from_reference
from dctpu_torch.kernels import rice_totals, vertical
from tests.test_torch_select import _corpus

# every product is 2**62 on the -2**31 samples of row 0: the int64 sum wraps
WRAP = (-(2**31),) * 4
TABLES = {f"default{i}": t.coeffs for i, t in enumerate(DEFAULT_LPC_TABLES)}
TABLES["wrap"] = WRAP


def _inputs(L, B=9, seed=5):
    """Raw samples (smooth, random, zero and -2**31 rows) with ragged n: a
    full block, none, one sample, a cut at a sub-block boundary and a short
    last sub-block."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[::2] = (np.cumsum(rng.integers(-3, 4, size=(B, L)), axis=1)[::2]
              + 1000).astype(np.int32)
    x[0, :9] = np.int32(-(2**31))
    x[1] = 0
    h = rng.integers(-(2**28), 2**28, size=(B, 4)).astype(np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = L - 57
    n[-2] = 0
    n[3] = 128
    n[5] = 1
    return x, h, n


def _ref_totals(x, h, n, pred, coeffs, k_max):
    r = ref_predict.residuals_for_candidate(
        jnp.asarray(x), jnp.asarray(h), pred, coeffs
    )
    return np.asarray(rice_totals_pallas(
        ref_rice.zigzag(r), jnp.asarray(n), x.shape[1], k_max, interpret=True
    ))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k_max", [0, 24])
@pytest.mark.parametrize("L", [256, 300, 200])
def test_xbp_twin_matches_pallas(L, k_max):
    x, h, n = _inputs(L)
    got = rice_totals.rice_totals_xbp(*_torch(x, h, n), L, k_max)
    assert got.dtype == torch.int32 and got.shape == (2, x.shape[0], k_max + 1)
    for gi, pred in enumerate((DELTA, DOUBLE_DELTA)):
        want = _ref_totals(x, h, n, pred, None, k_max)
        assert np.array_equal(got[gi].numpy(), want)


@pytest.mark.parametrize("k_max", [0, 24])
@pytest.mark.parametrize("table", list(TABLES))
def test_lpc_twin_matches_pallas(table, k_max):
    x, h, n = _inputs(300)
    coeffs = TABLES[table]
    got = rice_totals.rice_totals_lpc(*_torch(x, h, n), coeffs, 300, k_max)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _ref_totals(x, h, n, LPC, coeffs, k_max))


CONFIGS = {
    "default": RefConfig(block_len=512),
    "delta": RefConfig(block_len=512, predictors=(DELTA,)),
    "lpc_only": RefConfig(block_len=512, predictors=(LPC,)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rice_select_matches_reference(rng, name):
    """The port's (choice, k) equal the predictor, table and k of the
    reference encode_blocks_body's RICE blocks."""
    ref_cfg = CONFIGS[name]
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    x, n, h, _, _ = api.build_blocks(_corpus("synth", rng), 512)
    want = ref_encode.encode_blocks_body(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "xla"
    )
    choice, k = encode.select_blocks(*_torch(x, n, h), cfg)
    cands = cfg.candidates()
    pred = [cands[c][0] for c in choice.tolist()]
    table = [cands[c][1] if cands[c][0] == LPC else 0 for c in choice.tolist()]
    assert pred == np.asarray(want.predictor).tolist()
    assert table == np.asarray(want.table_idx).tolist()
    assert k.tolist() == np.asarray(want.k).tolist()


def test_rice_select_computes_no_candidate_z(rng, monkeypatch):
    """The rice and the vertical selections take every candidate's totals
    or cost from the raw samples (K6's and VC's x forms): neither derives
    the zigzag residuals, and the vertical one runs no plain cost outside
    VC's twins."""
    cfg = from_reference(dataclasses.asdict(RefConfig(block_len=512)))
    vcfg = dataclasses.replace(cfg, coder="vertical")
    t = _torch(*api.build_blocks(_corpus("mixed", rng), 512)[:3])
    want = encode.select_blocks(*t, cfg)
    want_v = encode.select_blocks(*t, vcfg)

    def refuse(*args):
        raise AssertionError("plain stage called")

    monkeypatch.setattr(encode, "candidate_z", refuse)
    monkeypatch.setattr(vertical, "vertical_selection_cost", refuse)
    for g, w in zip(encode.select_blocks(*t, cfg), want):
        assert torch.equal(g, w)
    for g, w in zip(encode.select_blocks(*t, vcfg), want_v):
        assert torch.equal(g, w)


def _zeros():
    x = torch.zeros((2, 256), dtype=torch.int32)
    return x, torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("form", ["xbp", "lpc"])
def test_x_forms_refuse_k_max_25(form):
    """The reference asserts k_max + 4 <= 28 (dctpu/codec/rice.py)."""
    x, h, n = _zeros()
    with pytest.raises(ValueError, match="k_max"):
        if form == "xbp":
            rice_totals.rice_totals_xbp(x, h, n, 256, 25)
        else:
            rice_totals.rice_totals_lpc(x, h, n, TABLES["default0"], 256, 25)


@pytest.mark.parametrize(
    "coeffs", [(2**31, 0, 0, 0), (0, -(2**31) - 1, 0, 0), (1, 2, 3)]
)
def test_lpc_form_refuses_non_int32_coefficients(coeffs):
    with pytest.raises(ValueError, match="four int32"):
        rice_totals.rice_totals_lpc(*_zeros(), coeffs, 256, 24)
