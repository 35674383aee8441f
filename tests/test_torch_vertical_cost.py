"""VC (``vertical_cost_xbp``, ``vertical_cost_lpc``), the coder="vertical"
selection cost, and the vertical selection that runs it, vs the JAX
reference.

The reference has no Pallas kernel here: its cost is
``vertical_xla.vertical_selection_cost`` on ``encode._cand_z_fn``'s
candidate zigzag values, run in JAX on the CPU; its vertical selection is
``encode_blocks_body``'s in its portable formulation (backend="xla").
Integer codec: every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import encode as ref_encode
from dctpu.config import CodecConfig as RefConfig
from dctpu.config import LpcTable as RefLpcTable
from dctpu.constants import DELTA, LPC
from dctpu.kernels.vertical_xla import vertical_selection_cost as ref_cost
from dctpu_torch.codec import api, encode
from dctpu_torch.config import DEFAULT_LPC_TABLES, from_reference
from dctpu_torch.kernels import vertical, vertical_cost
from tests.test_torch_select import _corpus

# every product is 2**62 on the -2**31 samples of row 0: the int64 sum wraps
WRAP = (-(2**31),) * 4
TABLES = [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP]


def _inputs(L, seed=5, B=12):
    """Raw samples with ragged n (L, 0, 1, a sub-block boundary, < L):
    smooth, random, all-zero, constant (equal to its history: every
    candidate's cost is 0, so all tie) and -2**31 rows, and histories at
    the int32 extremes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[::2] = (np.cumsum(rng.integers(-3, 4, size=(B, L)), axis=1)[::2]
              + 1000).astype(np.int32)
    x[0, :9] = np.int32(-(2**31))
    x[1] = 0
    x[6] = 77
    h = rng.integers(-(2**28), 2**28, size=(B, 4)).astype(np.int32)
    h[1] = 0
    h[6] = 77
    h[7] = [-(2**31), 2**31 - 1, -(2**31), 2**31 - 1]
    h[8] = -(2**31)
    n = np.full(B, L, np.int32)
    n[-1] = L - 57
    n[-2] = 0
    n[3] = 128
    n[5] = 1
    return x, h, n


def _ref_costs(x, h, n, ref_cfg):
    """The reference's cost [C, B] of each candidate of ref_cfg."""
    cands = ref_cfg.candidates()
    cand_z = ref_encode._cand_z_fn(jnp.asarray(x), jnp.asarray(h), cands, ref_cfg)
    valid = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :] < jnp.asarray(n)[:, None]
    return np.stack([np.asarray(ref_cost(cand_z(ci), valid))
                     for ci in range(len(cands))])


def _ref_config(L, tables):
    return RefConfig(block_len=L, coder="vertical",
                     lpc_tables=tuple(RefLpcTable(4, c) for c in tables))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("L", [200, 256, 512])
def test_xbp_twin_matches_reference(L):
    x, h, n = _inputs(L)
    got = vertical_cost.vertical_cost_xbp(*_torch(x, h, n), L)
    assert got.dtype == torch.int32 and got.shape == (2, x.shape[0])
    want = _ref_costs(x, h, n, _ref_config(L, TABLES))[:2]
    assert np.array_equal(got.numpy(), want)
    assert got[:, 6].tolist() == [0, 0] and got[:, -2].tolist() == [0, 0]


@pytest.mark.parametrize("L", [200, 256, 512])
def test_lpc_twin_matches_reference(L):
    """Every default table and the wrap table."""
    x, h, n = _inputs(L)
    want = _ref_costs(x, h, n, _ref_config(L, TABLES))[2:]
    for coeffs, w in zip(TABLES, want):
        got = vertical_cost.vertical_cost_lpc(*_torch(x, h, n), coeffs, L)
        assert got.dtype == torch.int32 and got.shape == (x.shape[0],)
        assert np.array_equal(got.numpy(), w)


CONFIGS = {
    "default": RefConfig(block_len=512, coder="vertical"),
    "delta": RefConfig(block_len=512, predictors=(DELTA,), coder="vertical"),
    "lpc_only": RefConfig(block_len=512, predictors=(LPC,), coder="vertical"),
    "wrap": _ref_config(512, TABLES),
}


def _ref_select(x, n, h, ref_cfg):
    """(predictor, table_idx) lists of the reference's vertical blocks."""
    want = ref_encode.encode_blocks_body(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "xla"
    )
    return (np.asarray(want.predictor).tolist(),
            np.asarray(want.table_idx).tolist())


def _port_select(x, n, h, cfg):
    choice, k = encode.select_blocks(*_torch(x, n, h), cfg)
    cands = cfg.candidates()
    pred = [cands[c][0] for c in choice.tolist()]
    table = [cands[c][1] if cands[c][0] == LPC else 0 for c in choice.tolist()]
    assert choice.dtype == k.dtype == torch.int32 and not k.any()
    return pred, table


@pytest.mark.parametrize("name", list(CONFIGS))
def test_vertical_select_matches_reference(rng, name):
    """The port's choice equals the predictor and table of the reference
    encode_blocks_body's VERTICAL blocks; the edge blocks of _inputs too."""
    ref_cfg = CONFIGS[name]
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    L = ref_cfg.block_len
    x, n, h, _, _ = api.build_blocks(_corpus("synth", rng), L)
    ex, eh, en = _inputs(L)
    x, n, h = (np.concatenate(p) for p in ((x, ex), (n, en), (h, eh)))
    assert _port_select(x, n, h, cfg) == _ref_select(x, n, h, ref_cfg)


@pytest.mark.parametrize("k_max", [25, 30])
def test_vertical_select_ignores_k_max(rng, k_max):
    """The VERTICAL coder has no k: a k_max past the RICE bound (24) goes
    through to the same selection, as in the reference, whose vertical
    branch never reads k_max."""
    cfg = from_reference(dataclasses.asdict(
        RefConfig(block_len=512, coder="vertical", k_max=k_max)))
    x, n, h, _, _ = api.build_blocks(_corpus("mixed", rng), 512)
    assert _port_select(x, n, h, cfg) == _port_select(
        x, n, h, dataclasses.replace(cfg, k_max=24))


def _zeros(L=256):
    x = torch.zeros((2, L), dtype=torch.int32)
    return x, torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("form", ["xbp", "lpc"])
def test_cost_refuses_block_len_past_int32(form):
    """A block's cost, up to 32 * block_len, must fit the int32 sum."""
    with pytest.raises(ValueError, match="int32 cost"):
        if form == "xbp":
            vertical_cost.vertical_cost_xbp(*_zeros(), 2**26)
        else:
            vertical_cost.vertical_cost_lpc(*_zeros(), TABLES[0], 2**26)


@pytest.mark.parametrize(
    "coeffs", [(2**31, 0, 0, 0), (0, -(2**31) - 1, 0, 0), (1, 2, 3)]
)
def test_lpc_form_refuses_non_int32_coefficients(coeffs):
    with pytest.raises(ValueError, match="four int32"):
        vertical_cost.vertical_cost_lpc(*_zeros(), coeffs, 256)


def test_twins_are_the_plain_cost(monkeypatch):
    """On the CPU both wrappers run the plain cost, once per candidate, and
    launch nothing."""
    calls = []
    real = vertical.vertical_selection_cost

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(vertical_cost, "vertical_selection_cost", counting)
    launches = (vertical_cost.vertical_cost_xbp.launches,
                vertical_cost.vertical_cost_lpc.launches)
    vertical_cost.vertical_cost_xbp(*_zeros(), 256)
    vertical_cost.vertical_cost_lpc(*_zeros(), TABLES[0], 256)
    assert len(calls) == 3
    assert launches == (vertical_cost.vertical_cost_xbp.launches,
                        vertical_cost.vertical_cost_lpc.launches)
