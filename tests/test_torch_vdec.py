"""K4 plain twin and the plain-torch RICE packer/unpacker vs the JAX reference.

The reference decode kernel runs in interpret mode on the CPU (it needs
block_len % 128 == 0); at other block lengths the twin is held against the
reference's XLA decoder.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import rice as ref_rice
from dctpu.kernels.pack_xla import pack_xla
from dctpu.kernels.unpack_xla import unpack_xla
from dctpu.kernels.vdec_pallas import decode_vertical_mega
from dctpu.kernels.vertical_xla import decode_vertical as ref_decode_vertical
from dctpu.kernels.vertical_xla import encode_vertical as ref_encode_vertical
from dctpu_torch.codec import rice
from dctpu_torch.constants import subs_per_block, sync_words
from dctpu_torch.kernels import vdec
from dctpu_torch.kernels.rice_pack import pack_plain
from dctpu_torch.kernels.rice_unpack import unpack
from dctpu_torch.kernels.vertical import parse_sync


def _decode_inputs(rng, L, B=6):
    """The inputs of tests/test_vemit.py's decode test."""
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF
    z[1] = 0
    z[2, 5] = 0x7FFFFFFF
    # bit-planed value layout: many exceptions of widely spread magnitude
    # at a small base width
    z[4, :] = rng.integers(0, 4, size=L).astype(np.uint32)
    z[4, :16] = (1 << rng.integers(20, 31, size=16)).astype(np.uint32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)
    n[-2] = 0
    return z, n


@pytest.mark.parametrize("L", [256, 4096, 200, 300])
def test_k4_twin_matches_reference(rng, L):
    z, n = _decode_inputs(rng, L)
    zj, nj = jnp.asarray(z), jnp.asarray(n)
    payload, _ = ref_encode_vertical(zj, nj, L, exc_backend="xla")
    if L % 128 == 0:
        want = decode_vertical_mega(payload, nj, L, interpret=True)
    else:
        want = ref_decode_vertical(payload, nj, L)
    rows = torch.from_numpy(np.array(payload).view(np.int32))
    _, n_exc, e, _ = parse_sync(rows[:, : sync_words(L)], subs_per_block(L))
    assert bool((n_exc > (e + 1) // 2).any()), "no bit-planed layout exercised"
    got = vdec.decode_vertical_plain(rows, torch.from_numpy(n), L)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(got.numpy().view(np.uint32), np.where(valid, z, 0))


def _rice_inputs(rng, L, B=5):
    z = (rng.geometric(0.05, size=(B, L)) - 1).astype(np.uint32)
    z[0, :40] = rng.integers(0, 2**32, size=40, dtype=np.uint64).astype(np.uint32)
    k = np.array([0, 3, 24, 7, 1][:B], np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)
    n[-2] = 0
    return z, k, n


@pytest.mark.parametrize("L", [256, 200, 4096])
def test_rice_pack_unpack_match_reference(rng, L):
    z, k, n = _rice_inputs(rng, L)
    zj, kj, nj = jnp.asarray(z), jnp.asarray(k), jnp.asarray(n)
    valid = np.arange(L)[None, :] < n[:, None]
    lo, hi, ln = ref_rice.codewords(zj, kj[:, None])
    p_ref, bl_ref = pack_xla(lo, hi, ln, jnp.asarray(valid), L)

    zt = torch.from_numpy(z.view(np.int32))
    code, length = rice.codewords(zt, torch.from_numpy(k)[:, None])
    p, bl = pack_plain(code, length, torch.from_numpy(valid), L)
    assert np.array_equal(bl.numpy(), np.asarray(bl_ref))
    assert np.array_equal(p.numpy().view(np.uint32), np.asarray(p_ref))

    rows = np.pad(np.asarray(p_ref), ((0, 0), (0, 2)))
    want = np.asarray(unpack_xla(jnp.asarray(rows), kj, nj, L))
    got = unpack(
        torch.from_numpy(rows.view(np.int32)), torch.from_numpy(k),
        torch.from_numpy(n), L,
    )
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, np.where(valid, z, 0))
