"""K6's plain twin and the port's Rice math vs the JAX reference.

The reference Pallas kernel (``rice_totals_pallas``) runs in interpret
mode on the CPU; ``choose_k_planes`` is the reference's portable
formulation of the same k choice. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import rice as ref_rice
from dctpu.kernels.select_pallas import rice_totals_pallas
from dctpu_torch.codec import rice
from dctpu_torch.kernels import rice_totals
from tests.test_torch_select import _select_inputs

K_MAX = 24


def _torch(z, n):
    return torch.from_numpy(z.view(np.int32)), torch.from_numpy(n)


@pytest.mark.parametrize("L", [256, 300])
def test_k6_twin_matches_pallas(rng, L):
    z, _, _, n = _select_inputs(rng, L, B=9)
    want = rice_totals_pallas(
        jnp.asarray(z), jnp.asarray(n), L, K_MAX, interpret=True
    )
    got = rice_totals.rice_totals(*_torch(z, n), L, K_MAX)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L", [256, 300])
def test_choose_k_auto_matches_planes(rng, L):
    z, _, _, n = _select_inputs(rng, L, B=9)
    k_ref, bits_ref = ref_rice.choose_k_planes(
        jnp.asarray(z), jnp.asarray(n), L, K_MAX
    )
    k, bits = rice.choose_k_auto(*_torch(z, n), L, K_MAX)
    assert np.array_equal(k.numpy(), np.asarray(k_ref))
    assert np.array_equal(bits.numpy(), np.asarray(bits_ref))


@pytest.mark.parametrize("k", [0, 5, 27])
def test_code_lengths_match_reference(rng, k):
    z, _, _, _ = _select_inputs(rng, 256)
    kk = np.full((z.shape[0], 1), k, np.int32)
    want = ref_rice.code_lengths(jnp.asarray(z), jnp.asarray(kk))
    got = rice.code_lengths(torch.from_numpy(z.view(np.int32)), torch.from_numpy(kk))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_rice_bounds_raise():
    """k_max above 24 (the reference asserts k_max + 4 <= 28) and a
    block_len past the packed key raise ValueError instead."""
    z = torch.zeros((2, 256), dtype=torch.int32)
    n = torch.full((2,), 256, dtype=torch.int32)
    k, bits = rice.choose_k_auto(z, n, 256, 24)
    assert k.tolist() == [0, 0] and bits.tolist() == [256, 256]
    with pytest.raises(ValueError, match="k_max"):
        rice.choose_k_auto(z, n, 256, 25)
    with pytest.raises(ValueError, match="block_len"):
        rice_totals.rice_totals(z, n, 2**26 // 48 + 1, 24)
