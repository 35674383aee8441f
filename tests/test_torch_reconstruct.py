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


def test_cpu_decode_goes_through_reconstruct(monkeypatch):
    """decompress calls kernels.reconstruct once per coder group."""
    streams, ids, cads = synth_corpus(4, 3000, seed=9, cumulative_frac=0.5)
    frame = api.compress(streams, CodecConfig(block_len=512, coder="adaptive"),
                         ids, cads, device="cpu")
    groups = len(set(frame.blocks.coder_arr().tolist()))
    assert groups == 2
    calls = []
    inner = reconstruct.reconstruct

    def counted(*args):
        calls.append(args[0].shape)
        return inner(*args)

    monkeypatch.setattr(reconstruct, "reconstruct", counted)
    out = api.decompress(read_frame(write_frame(frame)), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(streams, out))
    assert len(calls) == groups
    assert sum(shape[0] for shape in calls) == frame.blocks.num_blocks
