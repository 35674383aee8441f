"""K7 plain twin and adaptive_select(backend="reduce") vs the JAX reference.

The reference kernel runs in interpret mode on the CPU; the reference
selection under "reduce" takes its portable formulation there, which the
kernel must equal (tests/test_adaptive.py). Integer codec: exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import encode as ref_encode
from dctpu.config import CodecConfig as RefConfig
from dctpu.kernels.select_pallas import adaptive_totals_pallas
from dctpu_torch.codec import api, encode
from dctpu_torch.config import CodecConfig, from_reference
from dctpu_torch.kernels import select_bp, select_reduce
from tests.test_adaptive import _mixed_streams

K_MAX = 24


def _reduce_inputs(rng, L, B=9):
    """The inputs of tests/test_adaptive.py's K7 test, plus rows with more
    than EXC_CAP wide samples in a sub-block."""
    z = (rng.geometric(0.02, size=(B, L)) - 1).astype(np.uint32)
    z[0, 5] = 0xFFFFFFFF  # escape-heavy lane
    z[1] = 0
    z[2, :40] = (1 << rng.integers(10, 32, size=40)).astype(np.uint32)
    z[3] = rng.integers(0, 2**32, size=L, dtype=np.uint64).astype(np.uint32)
    n = np.full(B, L, np.int32)
    n[-1] = 3
    n[-2] = 0
    n[4] = 128  # cut at a sub-block boundary
    return z, n


@pytest.mark.parametrize("L", [256, 200])
def test_k7_twin_matches_pallas(rng, L):
    z, n = _reduce_inputs(rng, L)
    t_ref, v_ref = adaptive_totals_pallas(
        jnp.asarray(z), jnp.asarray(n), L, K_MAX, interpret=True
    )
    zt, nt = torch.from_numpy(z.view(np.int32)), torch.from_numpy(n)
    t, v = select_reduce.adaptive_totals_reduce(zt, nt, L, K_MAX)
    assert t.dtype == v.dtype == torch.int32
    assert np.array_equal(t.numpy(), np.asarray(t_ref))
    assert np.array_equal(v.numpy(), np.asarray(v_ref))
    # K2's contract, in K2's formulation
    t2, v2 = select_bp.adaptive_totals_bp_plain(zt, nt, L, K_MAX)
    assert torch.equal(t, t2) and torch.equal(v, v2)


def test_adaptive_select_reduce_matches_reference():
    ref_cfg = RefConfig(block_len=512, coder="adaptive")
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    x, n, h, _, _ = api.build_blocks(_mixed_streams(np.random.default_rng(1234)), 512)
    want = ref_encode.adaptive_select(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "reduce"
    )
    args = (torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(h), cfg)
    got = encode.adaptive_select(*args, backend="reduce")
    for g, w, a in zip(got, want, encode.adaptive_select(*args)):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, a)
    assert set(got[1].tolist()) == {0, 1}  # both coders chosen


def test_k7_raises_where_reference_asserts():
    z = torch.zeros((2, 256), dtype=torch.int32)
    n = torch.full((2,), 256, dtype=torch.int32)
    with pytest.raises(AssertionError):
        adaptive_totals_pallas(
            jnp.zeros((2, 256), jnp.uint32), jnp.asarray(n.numpy()), 256, 25,
            interpret=True,
        )
    with pytest.raises(ValueError, match="k_max"):
        select_reduce.adaptive_totals_reduce(z, n, 256, 25)
    with pytest.raises(ValueError, match="block_len"):
        select_reduce.adaptive_totals_reduce(z, n, 2**26 // 48 + 1, 24)
    cfg = CodecConfig(block_len=256, k_max=25, coder="adaptive")
    h = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_max"):
        encode.adaptive_select(z, n, h, cfg, backend="reduce")
    # K1/K2 take k_max up to 27, so the default backend selects
    encode.adaptive_select(z, n, h, cfg)
