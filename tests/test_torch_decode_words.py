"""K5b's and K4's words forms (their plain twins on the CPU) vs the JAX
reference's decoders.

Both take the frame's compact words and read each block in place,
``words[start_i : start_i + count_i]``. Here several blocks are laid out in
one ``words`` tensor in a shuffled order, each behind words of no block
(non-zero; ``chip_smoke.scatter_blocks``), and held, exactly, against ``unpack_pallas`` (interpret mode)
and ``unpack_scan`` on the reference's ``stage_rice_scan`` rows, and against
``decode_vertical_mega`` (interpret mode, block_len % 128 == 0) or the
XLA ``decode_vertical`` (other block lengths). Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import scatter_blocks
from dctpu.kernels.attic.unpack_pallas import unpack_pallas
from dctpu.kernels.unpack_scan import (
    buf_bucket,
    max_sub_bits_host,
    stage_rice_scan,
    unpack_scan,
)
from dctpu.kernels.vdec_pallas import decode_vertical_mega
from dctpu.kernels.vertical_xla import decode_vertical as ref_decode_vertical
from dctpu.kernels.vertical_xla import encode_vertical as ref_encode_vertical
from dctpu_torch.constants import sync_words
from dctpu_torch.kernels import ragged, rice_pack, rice_unpack, vdec


def _rice_inputs(L, B=8):
    """z with an all-escape, a full-range and an all-zero row; n = L, 0,
    1, 128 and L - 57; every k in 0..27."""
    rng = np.random.default_rng(L)
    z = rng.integers(0, 2**30, size=(B, L), dtype=np.uint64).astype(np.uint32)
    z >>= (np.arange(B) * 4 % 28)[:, None].astype(np.uint32)
    z[1] = 0xFFFFFFFF  # every codeword an escape of exactly 48 bits
    z[2] = rng.integers(0, 2**32, size=L, dtype=np.uint64).astype(np.uint32)
    z[3] = 0
    n = np.full(B, L, np.int32)
    n[4], n[5], n[6], n[7] = 0, 1, 128, L - 57
    k = (np.arange(B) * 4 % 28).astype(np.int32)
    return z, k, n


def _rice_words(L):
    z, k, n = _rice_inputs(L)
    payload, bit_len = rice_pack.rice_pack(
        torch.from_numpy(z.view(np.int32)), torch.from_numpy(k),
        torch.from_numpy(n), L,
    )
    flat = ragged.compact_payload(payload, bit_len, L)
    wc = ragged.payload_word_counts(bit_len, L)
    return z, k, n, flat, wc


@pytest.mark.parametrize("L", [256, 300])
def test_k5b_words_twin_matches_pallas_and_scan(L):
    z, k, n, flat, wc = _rice_words(L)
    off = np.concatenate([[0], np.cumsum(wc.numpy())])
    flat_u = flat.numpy().view(np.uint32)
    ub = buf_bucket(max_sub_bits_host(flat_u, off, L))
    staged = jnp.asarray(stage_rice_scan(flat_u, off, L, ub))
    kj, nj = jnp.asarray(k), jnp.asarray(n)
    z_pal = np.asarray(unpack_pallas(staged, kj, nj, L, ub, interpret=True))
    z_scan = np.asarray(unpack_scan(staged, kj, nj, L, ub))

    words, start, count = scatter_blocks(flat, wc, seed=L)
    got = rice_unpack.rice_unpack_words(
        words, start, count, torch.from_numpy(k), torch.from_numpy(n), L
    )
    assert got.dtype == torch.int32 and got.shape == (len(n), L)
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, z_pal)
    assert np.array_equal(got, z_scan)
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(got, np.where(valid, z, 0))


@pytest.mark.parametrize("L", [256, 300])
def test_k5b_words_read_nothing_past_count(L):
    """Blocks cut short (count below their words, one below its sync
    table) decode as their zero-padded rows do, and no word past a block's
    count reaches its z: overwriting those words changes nothing."""
    _, k, n, flat, wc = _rice_words(L)
    words, start, count = scatter_blocks(flat, wc, seed=L + 1)
    count[0] -= 5
    count[2] = wc[2] // 2
    count[5] = 0
    kt, nt = torch.from_numpy(k), torch.from_numpy(n)
    got = rice_unpack.rice_unpack_words(words, start, count, kt, nt, L)
    rows = ragged.pad_payload(words, start, count, rice_unpack.row_words(L))
    assert torch.equal(got, rice_unpack.unpack(rows, kt, nt, L))
    past = ragged.segment_index(start + count, wc - count + 3)
    words[past] = -1
    assert torch.equal(rice_unpack.rice_unpack_words(words, start, count, kt, nt, L), got)
    # the uncut blocks still decode to their samples
    want = rice_unpack.unpack(ragged.pad_payload(flat, torch.cumsum(wc, 0) - wc, wc,
                                            rice_unpack.row_words(L)), kt, nt, L)
    for i in (1, 3, 4, 6, 7):
        assert torch.equal(got[i], want[i])


def _vertical_inputs(rng, L, B=6):
    """The inputs of tests/test_torch_vdec.py (bit-planed values in row 4)."""
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF
    z[1] = 0
    z[2, 5] = 0x7FFFFFFF
    z[4, :] = rng.integers(0, 4, size=L).astype(np.uint32)
    z[4, :16] = (1 << rng.integers(20, 31, size=16)).astype(np.uint32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)
    n[-2] = 0
    return z, n


def _vertical_words(rng, L):
    z, n = _vertical_inputs(rng, L)
    nj = jnp.asarray(n)
    payload, bits = ref_encode_vertical(jnp.asarray(z), nj, L, exc_backend="xla")
    if L % 128 == 0:
        want = decode_vertical_mega(payload, nj, L, interpret=True)
    else:
        want = ref_decode_vertical(payload, nj, L)
    rows = torch.from_numpy(np.array(payload).view(np.int32))
    flat, wc = ragged.compact_vertical(rows, torch.from_numpy(np.array(bits)), L)
    return z, n, np.asarray(want), flat, wc


@pytest.mark.parametrize("L", [256, 4096, 200, 300])
def test_k4_words_twin_matches_reference(rng, L):
    z, n, want, flat, wc = _vertical_words(rng, L)
    words, start, count = scatter_blocks(flat, wc, seed=L)
    got = vdec.decode_vertical_words(words, start, count, torch.from_numpy(n), L)
    assert got.dtype == torch.int32 and got.shape == (len(n), L)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(got.numpy().view(np.uint32), np.where(valid, z, 0))
    # no word past a block's count reaches its z
    words[ragged.segment_index(start + count, torch.full_like(count, 3))] = -1
    again = vdec.decode_vertical_words(words, start, count, torch.from_numpy(n), L)
    assert torch.equal(again, got)


@pytest.mark.parametrize(
    "fault", ["width", "exceptions", "count_high", "count_low", "count_in_sync"]
)
def test_k4_words_rejects_bad_sync_tables(rng, fault):
    """A sync entry with b > 32 or n_exc > 16, or a count that the entries
    do not add up to, raises the twin's ValueError."""
    L = 300
    _, n, _, flat, wc = _vertical_words(rng, L)
    words, start, count = scatter_blocks(flat, wc, seed=5)
    i = 3
    sub1 = words[start[i]] & -(1 << 16)  # keep sub 1's entry, rewrite sub 0's
    if fault == "width":
        words[start[i]] = sub1 | 40
    elif fault == "exceptions":
        words[start[i]] = sub1 | (17 << 6) | 2
    elif fault == "count_high":
        count[i] += 1
    elif fault == "count_low":
        count[i] -= 1
    else:
        count[i] = sync_words(L) - 1
    with pytest.raises(ValueError, match="sync table does not match"):
        vdec.decode_vertical_words(words, start, count, torch.from_numpy(n), L)
