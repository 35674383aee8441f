"""K5a's and K5b's plain twins vs the JAX reference's RICE packers.

K5a (``rice_pack.rice_pack`` on CPU tensors) is held against ``pack_pallas``
in interpret mode and the XLA ``pack_scan``; K5b (``rice_unpack.rice_unpack_words``
on the frame's compact words) against ``unpack_pallas`` and
``unpack_scan`` on the reference's ``stage_rice_scan`` rows of the same
disk words. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import rice as ref_rice
from dctpu.format.frame import payload_word_counts
from dctpu.kernels.attic.pack_pallas import pack_pallas
from dctpu.kernels.attic.unpack_pallas import unpack_pallas
from dctpu.kernels.pack_scan import pack_scan
from dctpu.kernels.unpack_scan import (
    buf_bucket,
    max_sub_bits_host,
    stage_rice_scan,
    unpack_scan,
)
from dctpu_torch.kernels import rice_pack, rice_unpack

K_CASES = ("0", "5", "27", "mixed")


def _inputs(L, k_case, B=8):
    """z with an all-escape, a full-range and an all-zero row; n = L, 0,
    1, 128 and L - 57; k fixed per case or every k in 0..27."""
    rng = np.random.default_rng(L)
    top = 27 if k_case == "mixed" else int(k_case)
    z = rng.integers(0, 2 ** (top + 3), size=(B, L), dtype=np.uint64)
    z = z.astype(np.uint32)
    z[1] = 0xFFFFFFFF  # every codeword an escape of exactly 48 bits
    z[2] = rng.integers(0, 2**32, size=L, dtype=np.uint64).astype(np.uint32)
    z[3] = 0
    n = np.full(B, L, np.int32)
    n[4], n[5], n[6], n[7] = 0, 1, 128, L - 57
    k = (
        (np.arange(B) * 4 % 28) if k_case == "mixed" else np.full(B, top)
    ).astype(np.int32)
    return z, k, n


def _reference_pack(z, k, n, L):
    nj = jnp.asarray(n)
    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < nj[:, None]
    lo, hi, ln = ref_rice.codewords(jnp.asarray(z), jnp.asarray(k)[:, None])
    return (
        pack_pallas(lo, hi, ln, valid, L, interpret=True),
        pack_scan(lo, hi, ln, valid, L),
    )


def _port_pack(z, k, n, L):
    return rice_pack.rice_pack(
        torch.from_numpy(z.view(np.int32)), torch.from_numpy(k),
        torch.from_numpy(n), L,
    )


@pytest.mark.parametrize("L", [256, 300])
@pytest.mark.parametrize("k_case", K_CASES)
def test_k5a_twin_matches_pallas_and_scan(L, k_case):
    z, k, n = _inputs(L, k_case)
    (p_pal, bl_pal), (p_scan, bl_scan) = _reference_pack(z, k, n, L)
    payload, bit_len = _port_pack(z, k, n, L)
    assert payload.dtype == torch.int32 and bit_len.dtype == torch.int64
    for p_ref, bl_ref in ((p_pal, bl_pal), (p_scan, bl_scan)):
        assert np.array_equal(payload.numpy().view(np.uint32), np.asarray(p_ref))
        assert np.array_equal(bit_len.numpy(), np.asarray(bl_ref))


@pytest.mark.parametrize("L", [256, 300])
@pytest.mark.parametrize("k_case", K_CASES)
def test_k5b_twin_matches_pallas_and_scan(L, k_case):
    z, k, n = _inputs(L, k_case)
    payload, bit_len = _port_pack(z, k, n, L)
    # compact to the frame's disk words, then stage both sides' rows
    wc = payload_word_counts(bit_len.numpy(), L)
    off = np.zeros(wc.size + 1, np.int64)
    np.cumsum(wc, out=off[1:])
    rows = payload.numpy().view(np.uint32)
    flat = np.concatenate([rows[i, : wc[i]] for i in range(rows.shape[0])])
    ub = buf_bucket(max_sub_bits_host(flat, off, L))
    staged = jnp.asarray(stage_rice_scan(flat, off, L, ub))
    kj, nj = jnp.asarray(k), jnp.asarray(n)
    z_pal = np.asarray(unpack_pallas(staged, kj, nj, L, ub, interpret=True))
    z_scan = np.asarray(unpack_scan(staged, kj, nj, L, ub))

    got = rice_unpack.rice_unpack_words(
        torch.from_numpy(flat.view(np.int32)), torch.from_numpy(off[:-1]),
        torch.from_numpy(wc), torch.from_numpy(k), torch.from_numpy(n), L,
    ).numpy().view(np.uint32)
    assert np.array_equal(got, z_pal)
    assert np.array_equal(got, z_scan)
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(got, np.where(valid, z, 0))
