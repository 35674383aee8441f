"""K1/K2's bit-length identity and K2's LPC form vs the JAX reference.

The reference Pallas kernel runs in interpret mode on the CPU; the
reference selection takes its portable formulation (backend="xla").
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
from dctpu.constants import LPC
from dctpu.kernels.select_bp import adaptive_totals_bp
from dctpu_torch.codec import api, encode, rice
from dctpu_torch.config import DEFAULT_LPC_TABLES, from_reference
from dctpu_torch.kernels import select_bp
from tests.test_torch_select import _corpus, _select_inputs

K_MAX = 24
# every product is 2**62 on the -2**31 samples of row 0: the int64 sum wraps
WRAP = (-(2**31),) * 4
TABLES = {f"default{i}": t.coeffs for i, t in enumerate(DEFAULT_LPC_TABLES)}
TABLES["wrap"] = WRAP


@pytest.mark.parametrize("k_max", [0, 24, 27])
@pytest.mark.parametrize("L", [256, 200, 4096])
def test_identity_matches_definition_and_reference(rng, L, k_max):
    z, _, _, n = _select_inputs(rng, L)
    zt, nt = torch.from_numpy(z.view(np.int32)), torch.from_numpy(n)
    got = select_bp.rice_totals_from_lengths(zt, nt, k_max)
    assert torch.equal(got, rice.rice_totals(zt, nt, k_max))
    t_ref, _ = adaptive_totals_bp(
        jnp.asarray(z), jnp.asarray(n), L, k_max, interpret=True
    )
    assert np.array_equal(got.numpy(), np.asarray(t_ref))
    if k_max <= 24:  # choose_k_planes' own bound
        k_ref, bits_ref = ref_rice.choose_k_planes(
            jnp.asarray(z), jnp.asarray(n), L, k_max
        )
        k, bits = rice.best_k(got)
        assert np.array_equal(k.numpy(), np.asarray(k_ref))
        assert np.array_equal(bits.numpy(), np.asarray(bits_ref))


def test_wrap_table_wraps_the_accumulator(rng):
    """Row 0 of the inputs holds -2**31 samples: the exact LPC sum of
    WRAP leaves the int64 range, so the cases below reach the wrap."""
    _, x, _, _ = _select_inputs(rng, 256)
    exact = [sum(c * int(x[0, t - 1 - j]) for j, c in enumerate(WRAP))
             for t in range(4, 9)]
    assert max(exact) >= 2**63


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("L", [256, 200])
def test_lpc_form_matches_reference(rng, L, table):
    _, x, h, n = _select_inputs(rng, L)
    coeffs = TABLES[table]
    r = ref_predict.residuals_for_candidate(
        jnp.asarray(x), jnp.asarray(h), LPC, coeffs
    )
    t_ref, v_ref = adaptive_totals_bp(
        ref_rice.zigzag(r), jnp.asarray(n), L, K_MAX, interpret=True
    )
    t, v = select_bp.adaptive_totals_lpc(
        torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(n),
        coeffs, L, K_MAX,
    )
    assert t.dtype == v.dtype == torch.int32
    assert np.array_equal(t.numpy(), np.asarray(t_ref))
    assert np.array_equal(v.numpy(), np.asarray(v_ref))


@pytest.mark.parametrize("name", ["mixed", "synth"])
def test_adaptive_select_computes_no_candidate_z(rng, monkeypatch, name):
    """The default backend takes every candidate's totals from the raw
    samples; backend="reduce" still derives the zigzag residuals."""
    ref_cfg = RefConfig(block_len=512, coder="adaptive")
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    x, n, h, _, _ = api.build_blocks(_corpus(name, rng), 512)
    want = ref_encode.adaptive_select(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "xla"
    )

    def refuse(*args):
        raise AssertionError("candidate_z called")

    monkeypatch.setattr(encode, "candidate_z", refuse)
    t = [torch.from_numpy(a) for a in (x, n, h)]
    got = encode.adaptive_select(*t, cfg)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError, match="candidate_z called"):
        encode.adaptive_select(*t, cfg, backend="reduce")


def test_lpc_form_refuses_bad_coefficients_and_devices():
    x = torch.zeros((2, 256), dtype=torch.int32)
    h = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    for coeffs in [(2**31, 0, 0, 0), (0, -(2**31) - 1, 0, 0), (1, 2, 3)]:
        with pytest.raises(ValueError, match="four int32"):
            select_bp.adaptive_totals_lpc(x, h, n, coeffs, 256, K_MAX)
    meta = [t.to("meta") for t in (x, h, n)]
    with pytest.raises(ValueError, match="unsupported device"):
        select_bp.adaptive_totals_lpc(*meta, WRAP, 256, K_MAX)
