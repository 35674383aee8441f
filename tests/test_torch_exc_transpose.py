"""K8's plain twin and K9's lane-reversed twin vs the JAX reference.

The reference kernels run in interpret mode on the CPU and are held,
with the twins, against the reference's XLA formulations
(exc_extract_xla, bit_transpose32). K9's card contract, the planes in
disk order, is tested in test_torch_pack_rows.py. Integer codec: exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.kernels.transpose_pallas import grouped_bit_transpose32 as ref_k9
from dctpu.kernels.vertical_pallas import exc_extract_pallas
from dctpu.kernels.vertical_xla import bit_transpose32 as ref_bit_transpose32
from dctpu.kernels.vertical_xla import exc_extract_xla
from dctpu_torch.kernels import exc_extract, transpose, vertical


def _exc_inputs(rng, B=7, S=32):
    """The inputs of tests/test_vertical_pallas.py, plus rows with more
    than EXC_CAP exceptions at their width."""
    zs = (rng.geometric(0.08, size=(B, S, 128)) - 1).astype(np.uint32)
    for i in range(B):  # ragged tails
        zs[i, -1, rng.integers(0, 129):] = 0
    zs[2, :4, :] = 0xFFFFFFFF
    b = rng.integers(0, 33, size=(B, S)).astype(np.int32)
    b[0] = 0   # every nonzero sample is an exception
    b[1] = 32  # no exceptions possible
    b[2, :4] = [0, 5, 31, 32]  # 128 exceptions, ranks >= 16 dropped
    return zs, b


def test_k8_twin_matches_pallas_and_xla(rng):
    zs, b = _exc_inputs(rng)
    px, vx = exc_extract_xla(jnp.asarray(zs), jnp.asarray(b))
    pp, vp = exc_extract_pallas(jnp.asarray(zs), jnp.asarray(b), interpret=True)
    pos, vals = exc_extract.exc_extract(
        torch.from_numpy(zs.view(np.int32)), torch.from_numpy(b)
    )
    assert pos.dtype == vals.dtype == torch.int32
    assert pos.shape == (7, 32, 4) and vals.shape == (7, 32, 16)
    for got, want in ((pos, px), (pos, pp), (vals, vx), (vals, vp)):
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert not vals[1].any() and not pos[1].any()  # b = 32
    assert (vals[2, 0] == -1).all()  # b = 0: the first 16 of 128


def _words(rng, R=70):
    x = rng.integers(0, 2**32, size=(R, 4, 32), dtype=np.uint64).astype(np.uint32)
    x[0] = 0
    x[1] = 0xFFFFFFFF
    x[2, :, ::2] = 0x80000001  # every other word set in both end bits
    return x


def test_bit_transpose32_matches_reference(rng):
    x = _words(rng)
    want = np.asarray(ref_bit_transpose32(jnp.asarray(x)))
    got = vertical.bit_transpose32(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int64  # u32 values
    assert np.array_equal(got.numpy(), want)
    # self-inverse
    assert np.array_equal(vertical.bit_transpose32(got).numpy(), x)


@pytest.mark.parametrize("R", [70, 3])
def test_k9_twin_matches_pallas(rng, R):
    x = _words(rng, R)
    xr = np.ascontiguousarray(x[..., ::-1].reshape(R, 128))
    want = np.asarray(ref_k9(jnp.asarray(xr), interpret=True, tr=64))
    got = transpose.grouped_bit_transpose32_plain(
        torch.from_numpy(xr.view(np.int32))
    )
    assert got.shape == (R, 128) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # rev(K9(rev(x))) == bit_transpose32(x), and twice is the identity
    out = got.numpy().view(np.uint32).reshape(R, 4, 32)[..., ::-1]
    assert np.array_equal(out, np.asarray(ref_bit_transpose32(jnp.asarray(x))))
    back = transpose.grouped_bit_transpose32_plain(got).numpy().view(np.uint32)
    assert np.array_equal(back, xr)
    assert not got[0].any() and (got[1] == -1).all()
