"""R's plain twin (``kernels/reconstruct.py``) vs the JAX reference.

The reference is the tail of ``decode_blocks_body``: ``rice.unzigzag``,
``predict.reconstruct_all`` (cumsums and the LPC ``lax.scan``, whose
chunk is 32, 4 and 8 at block lengths 4096, 300 and 200) and the mask past
n. Integer codec: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import split_groups
from dctpu.codec import predict as ref_predict
from dctpu.codec import rice as ref_rice
from dctpu_torch.codec import api, predict
from dctpu_torch.config import DEFAULT_LPC_TABLES, CodecConfig
from dctpu_torch.corpus import synth_corpus
from dctpu_torch.format import read_frame, write_frame
from dctpu_torch.kernels import reconstruct

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# every product is 2**62 on -2**31 samples: the int64 sum wraps to 0
WRAP = (I32_MIN,) * 4
TABLES = np.array([t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP], np.int64)


def _inputs(L, seed=3):
    """Mixed predictors (DELTA, DOUBLE_DELTA, then LPC over every table),
    history at the int32 extremes, n in {0, 1, 127, 128, L-57, L} and
    garbage z past n; the last LPC row runs the wrap table on -2**31
    samples."""
    rng = np.random.default_rng(seed)
    B = 24
    z = (rng.geometric(0.05, size=(B, L)) - 1).astype(np.uint32)
    z[1::3] = rng.integers(0, 2**32, size=(len(range(1, B, 3)), L), dtype=np.uint64)
    pred = np.array([0, 0, 0, 1, 1, 1] + [2] * (B - 6), np.int32)
    table_idx = np.zeros(B, np.int32)
    table_idx[6:] = np.arange(B - 6) % len(TABLES)
    hist = rng.integers(I32_MIN, I32_MAX, size=(B, 4), endpoint=True).astype(np.int32)
    hist[::4] = np.array([I32_MIN, I32_MAX, I32_MIN, I32_MAX], np.int32)
    hist[2::4] = np.array([I32_MAX, I32_MIN, I32_MAX, I32_MIN], np.int32)
    n = np.array([0, 1, 127, 128, L - 57, L], np.int32)[np.arange(B) % 6]
    wrap = B - 1  # x stays -2**31: r = -2**31 (z = 0xFFFFFFFF) + 0
    table_idx[wrap] = len(TABLES) - 1
    hist[wrap] = I32_MIN
    z[wrap] = 0xFFFFFFFF
    n[wrap] = L
    return z, n, pred, table_idx, hist


def _reference(z, n, pred, table_idx, hist):
    r = ref_rice.unzigzag(jnp.asarray(z))
    x = ref_predict.reconstruct_all(
        r, jnp.asarray(hist), jnp.asarray(pred), jnp.asarray(TABLES),
        jnp.asarray(table_idx), has_lpc=True,
    )
    valid = jnp.arange(z.shape[1], dtype=jnp.int32)[None, :] < jnp.asarray(n)[:, None]
    return np.asarray(jnp.where(valid, x, 0))


@pytest.mark.parametrize("L", [4096, 300, 200])
def test_twin_matches_reference(L):
    z, n, pred, table_idx, hist = _inputs(L)
    want = _reference(z, n, pred, table_idx, hist)
    args = [torch.from_numpy(a) for a in (z.view(np.int32), n, pred, table_idx, hist)]
    coeffs = torch.from_numpy(TABLES.astype(np.int32))
    got = reconstruct.reconstruct_plain(*args, coeffs)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[-1] == I32_MIN).all()  # the wrap row
    # the wrapper runs the twin for CPU tensors
    assert torch.equal(reconstruct.reconstruct(*args, coeffs), got)


@pytest.mark.parametrize("L", [300, 200])
def test_delta_predictors_as_q16_tables(L):
    """The kernel runs DELTA and DOUBLE_DELTA as the LPC recurrence with the
    tables (2**16, 0, 0, 0) and (2**17, -2**16, 0, 0): exact, also on
    residuals and histories at the int32 extremes."""
    z, _, _, _, hist = _inputs(L, seed=8)
    r = torch.from_numpy(z.view(np.int32))
    h = torch.from_numpy(hist)
    B = r.shape[0]
    for table, inverse in (
        ((2**16, 0, 0, 0), predict.reconstruct_delta),
        ((2**17, -(2**16), 0, 0), predict.reconstruct_double_delta),
    ):
        coeffs = torch.tensor([table] * B, dtype=torch.int64)
        assert torch.equal(predict.reconstruct_lpc(r, h, coeffs), inverse(r, h))


@pytest.mark.parametrize("L", [300, 200])
def test_range_twin_matches_reference(L):
    """R's range form: each block's z row read from one of two coder groups'
    tensors through its source row, in shuffled orders, equals the
    reference on every predictor and table, histories and residuals at the
    int32 extremes and n = 0, n < L and n = L; and B = 0 gives [0, L]."""
    z, n, pred, table_idx, hist = _inputs(L, seed=5)
    want = _reference(z, n, pred, table_idx, hist)
    first, second, src = split_groups(torch.from_numpy(z.view(np.int32)), L)
    coeffs = torch.from_numpy(TABLES.astype(np.int32))
    heads = [torch.from_numpy(a) for a in (n, pred, table_idx, hist)]
    args = (first, *heads, coeffs)
    got = reconstruct.reconstruct_range_plain(*args, src, second)
    assert np.array_equal(got.numpy(), want)
    # the wrapper runs the range twin for CPU tensors
    assert torch.equal(reconstruct.reconstruct(*args, src=src, z1=second), got)
    # one group alone, its rows in reverse block order
    B = z.shape[0]
    got1 = reconstruct.reconstruct(
        torch.from_numpy(np.ascontiguousarray(z.view(np.int32)[::-1])), *heads,
        coeffs, src=torch.arange(B - 1, -1, -1, dtype=torch.int32))
    assert np.array_equal(got1.numpy(), want)
    empty = [t[:0] for t in heads]
    out = reconstruct.reconstruct(first, *empty, coeffs, src=src[:0], z1=second)
    assert out.shape == (0, L) and out.dtype == torch.int32


EDGES32 = np.array([I32_MIN, I32_MIN + 1, -(2**16), -1, 0, 1, 2**16,
                    I32_MAX - 1, I32_MAX], np.int64)


def test_short_chain_identity():
    """The step of recon.cu: q = c1 x2 + c2 x3 + c3 x4 formed a step ahead
    (wrapping mod 2**64), then acc = c0 x1 + q, and the prediction as bits
    16..47 of acc, ((hi << 16) | (lo >>> 16)) of its words, equals the low
    word of the reference's (c0 x1 + c1 x2 + c2 x3 + c3 x4) >> 16, on
    coefficients and samples at the int32 extremes and at random."""
    rng = np.random.default_rng(17)
    grid = np.stack(np.meshgrid(EDGES32, EDGES32, indexing="ij"), -1).reshape(-1, 2)
    rand = rng.integers(I32_MIN, I32_MAX, size=(4096, 8), endpoint=True)
    edge = rng.choice(EDGES32, size=(4096, 8))
    vals = np.concatenate([
        np.concatenate([grid, grid[::-1], grid, grid[::-1]], 1),
        rand, edge, np.where(rng.random((4096, 8)) < 0.5, rand, edge),
    ])
    c = torch.from_numpy(vals[:, :4])
    x = torch.from_numpy(vals[:, 4:])  # x_{t-1} .. x_{t-4}
    q = c[:, 1] * x[:, 1] + c[:, 2] * x[:, 2] + c[:, 3] * x[:, 3]  # wraps
    acc = c[:, 0] * x[:, 0] + q
    lo, hi = acc & 0xFFFFFFFF, (acc >> 32) & 0xFFFFFFFF
    funnel = ((hi << 16) | (lo >> 16)) & 0xFFFFFFFF
    # the reference's order (dctpu/codec/predict.py lpc_predict_encode)
    ref = (c[:, 0] * x[:, 0] + c[:, 1] * x[:, 1] + c[:, 2] * x[:, 2]
           + c[:, 3] * x[:, 3]) >> 16
    assert torch.equal(funnel, ref & 0xFFFFFFFF)
    assert torch.equal(funnel, (acc >> 16) & 0xFFFFFFFF)
    # some sums wrap int64, and both signs of acc occur
    assert bool((acc < 0).any()) and bool((acc > 0).any())


@pytest.mark.parametrize("chunk_blocks", [None, 3])
def test_cpu_decode_goes_through_reconstruct(monkeypatch, chunk_blocks):
    """decompress calls kernels.reconstruct once per decode range, over all
    of the range's blocks and both of its coder groups."""
    streams, ids, cads = synth_corpus(4, 3000, seed=9, cumulative_frac=0.5)
    frame = api.compress(streams, CodecConfig(block_len=512, coder="adaptive"),
                         ids, cads, device="cpu")
    groups = len(set(frame.blocks.coder_arr().tolist()))
    assert groups == 2
    B = frame.blocks.num_blocks
    ranges = api.block_ranges(B, chunk_blocks)
    calls = []
    inner = reconstruct.reconstruct

    def counted(*args, **kwargs):
        calls.append(args[1].shape[0])  # the range's blocks
        return inner(*args, **kwargs)

    monkeypatch.setattr(reconstruct, "reconstruct", counted)
    out = api.decompress(read_frame(write_frame(frame)), device="cpu",
                         chunk_blocks=chunk_blocks)
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert calls == [b - a for a, b in ranges]
    assert len(calls) == (1 if chunk_blocks is None else -(-B // 3))
