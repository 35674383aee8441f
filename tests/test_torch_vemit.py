"""K3 (its plain analysis and both row forms' twins), VERTICAL/RICE emission
and compaction vs the JAX reference.

The reference emit kernel runs in interpret mode on the CPU; the reference
emission takes its portable XLA formulation (backend="xla").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import api as ref_api
from dctpu.codec import encode as ref_encode
from dctpu.codec import vertical_host
from dctpu.config import CodecConfig as RefConfig
from dctpu.config import LpcTable as RefLpcTable
from dctpu.kernels.vemit_pallas import vertical_emit_mega
from dctpu.kernels.vertical_xla import encode_vertical as ref_encode_vertical
from dctpu_torch.codec import encode
from dctpu_torch.config import DEFAULT_LPC_TABLES, from_reference
from dctpu_torch.kernels import compact, ragged, vemit
from tests.test_adaptive import _mixed_streams


def _emit_inputs(rng, L, B=6):
    """The inputs of tests/test_vemit.py."""
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF          # many max-width exceptions
    z[1] = 0                        # all-zero block (b=0 everywhere)
    z[2, 5] = 0x7FFFFFFF            # single huge exception
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)          # ragged tail
    n[-2] = 0                       # empty block
    n[3] = min(L, 128)              # cut at sub-block boundary
    return z, n


def _stress_inputs(rng, L=256, B=17):
    """Exception counts swept 0..EXC_CAP at scattered positions."""
    z = rng.integers(0, 8, size=(B, L)).astype(np.uint32)
    for i in range(B):
        ne = i % 17
        pos = rng.choice(L, size=ne, replace=False)
        z[i, pos] = (1 << rng.integers(4, 31, size=ne)).astype(np.uint32)
    return z, np.full(B, L, np.int32)


def _cases(rng, L):
    return _stress_inputs(rng) if L == "stress" else _emit_inputs(rng, L)


@pytest.mark.parametrize("L", [256, 200, 4096, "stress"])
def test_k3_twin_matches_pallas(rng, L):
    z, n = _cases(rng, L)
    L = z.shape[1]
    want = vertical_emit_mega(jnp.asarray(z), jnp.asarray(n), L, interpret=True)
    got = vemit.vertical_emit(
        torch.from_numpy(z.view(np.int32)), torch.from_numpy(n), L
    )
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        w = np.asarray(w)
        assert np.array_equal(g.numpy().view(w.dtype), w)


@pytest.mark.parametrize("L", [256, 200, 4096, "stress"])
def test_encode_vertical_rows_match_reference(rng, L):
    """K3 + region assembly == the reference's staged payload rows."""
    z, n = _cases(rng, L)
    L = z.shape[1]
    p_ref, bl_ref = ref_encode_vertical(
        jnp.asarray(z), jnp.asarray(n), L, exc_backend="xla"
    )
    p, bl = encode.encode_vertical(
        torch.from_numpy(z.view(np.int32)), torch.from_numpy(n), L
    )
    assert np.array_equal(bl.numpy(), np.asarray(bl_ref))
    p_ref = np.asarray(p_ref)
    assert np.array_equal(p.numpy().view(np.uint32), p_ref)
    # compaction and staging: the host transforms of the reference
    words, wc = ragged.compact_vertical(p, bl, L)
    w_ref, wc_ref = vertical_host.compact_vertical(p_ref, L)
    assert np.array_equal(words.numpy().view(np.uint32), w_ref)
    assert np.array_equal(wc.numpy(), wc_ref)
    off = np.zeros(wc_ref.size + 1, np.int64)
    np.cumsum(wc_ref, out=off[1:])
    staged = ragged.stage_vertical(
        words, torch.from_numpy(off[:-1]), torch.from_numpy(wc_ref), L
    )
    assert np.array_equal(
        staged.numpy().view(np.uint32), vertical_host.stage_vertical(w_ref, off, L)
    )


@pytest.fixture(scope="module")
def mixed_blocks():
    """Blocks of _mixed_streams at block_len 512 and the reference's
    adaptive selection of them."""
    ref_cfg = RefConfig(block_len=512, coder="adaptive")
    x, n, h, _, _ = ref_api.build_blocks(
        _mixed_streams(np.random.default_rng(1234)), 512
    )
    choice, coder, k = (
        np.asarray(a) for a in ref_encode.adaptive_select(
            jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), ref_cfg, "xla"
        )
    )
    return ref_cfg, x, n, h, choice, coder, k


@pytest.mark.parametrize("gid, gname", [(0, "rice"), (1, "vertical")])
def test_group_emit_and_compaction_match_reference(mixed_blocks, gid, gname):
    ref_cfg, x, n, h, choice, coder, k = mixed_blocks
    idx = np.nonzero(coder == gid)[0]
    assert idx.size
    enc_ref = ref_encode.emit_blocks(
        jnp.asarray(x[idx]), jnp.asarray(n[idx]), jnp.asarray(h[idx]),
        jnp.asarray(choice[idx]), jnp.asarray(k[idx]), ref_cfg, gname, "xla",
    )
    bl_ref = np.asarray(enc_ref.bit_len)
    w_ref = ref_api.compact_enc_payload_device(enc_ref.payload, bl_ref, 512, gname)

    cfg = from_reference(dataclasses.asdict(ref_cfg))
    t = {name: torch.from_numpy(np.ascontiguousarray(a[idx]))
         for name, a in (("x", x), ("n", n), ("h", h), ("c", choice), ("k", k))}
    payload, bl = encode.emit_blocks(
        t["x"], t["n"], t["h"], t["c"], t["k"], cfg, gname
    )
    assert np.array_equal(bl.numpy(), bl_ref)
    words, wc = compact.compact_enc_payload(payload, bl, 512, gname)
    assert np.array_equal(words.numpy().view(np.uint32), w_ref)
    assert int(wc.sum()) == w_ref.size


@pytest.mark.parametrize("L", [256, 200, 4096, "stress"])
def test_rows_z_form_matches_reference(rng, L):
    """K3's z form (its twin on the CPU) == the reference's encode_vertical
    rows and bit lengths."""
    z, n = _cases(rng, L)
    L = z.shape[1]
    p_ref, bl_ref = ref_encode_vertical(
        jnp.asarray(z), jnp.asarray(n), L, exc_backend="xla"
    )
    p, bl = vemit.vertical_emit_rows_z(
        torch.from_numpy(z.view(np.int32)), torch.from_numpy(n), L
    )
    assert p.dtype == torch.int32 and bl.dtype == torch.int64
    assert np.array_equal(p.numpy().view(np.uint32), np.asarray(p_ref))
    assert np.array_equal(bl.numpy(), np.asarray(bl_ref))


# every product is 2**62 on the -2**31 samples of row 0: the int64 sum wraps
WRAP = (-(2**31),) * 4


def _x_inputs(rng, L, B=21):
    """Raw samples for the x form: smooth, random, zero and -2**31 rows,
    histories at the int32 extremes, ragged n (full, none, one sample, a
    sub-block boundary, L - 57), and each block's choice cycling through
    every candidate of the default tables plus the wrap table."""
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[::2] = (np.cumsum(rng.integers(-3, 4, size=(B, L)), axis=1)[::2]
              + 1000).astype(np.int32)
    x[0, :9] = np.int32(-(2**31))
    x[1] = 0
    h = rng.integers(-(2**31), 2**31, size=(B, 4)).astype(np.int32)
    h[::5] = np.array([-(2**31), 2**31 - 1, -(2**31), 2**31 - 1], np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = L - 57
    n[-2] = 0
    n[3] = 128
    n[5] = 1
    return x, h, n


def _x_stress(rng, L=256, B=17):
    """Small samples with 0..16 spikes per block: each spike gives DELTA two
    exceptions, so the counts pass EXC_CAP and move b."""
    x = rng.integers(0, 8, size=(B, L)).astype(np.int32)
    for i in range(B):
        ne = i % 17
        pos = rng.choice(L, size=ne, replace=False)
        x[i, pos] = (1 << rng.integers(4, 30, size=ne)).astype(np.int32)
    h = np.zeros((B, 4), np.int32)
    return x, h, np.full(B, L, np.int32)


@pytest.mark.parametrize("L", [4096, 200, "stress"])
def test_rows_x_form_matches_reference(rng, L):
    """K3's x form (its twin on the CPU), every candidate chosen, == the
    reference's emit_blocks rows of the VERTICAL coder."""
    x, h, n = _x_stress(rng) if L == "stress" else _x_inputs(rng, L)
    L = x.shape[1]
    ref_cfg = RefConfig(
        block_len=L, coder="vertical",
        lpc_tables=tuple(RefLpcTable(t.order, t.coeffs) for t in DEFAULT_LPC_TABLES)
        + (RefLpcTable(4, WRAP),),
    )
    C = len(ref_cfg.candidates())
    choice = (np.arange(x.shape[0]) % C).astype(np.int32)
    enc = ref_encode.emit_blocks(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), jnp.asarray(choice),
        jnp.zeros(x.shape[0], jnp.int32), ref_cfg, "vertical", "xla",
    )
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    t = [torch.from_numpy(a) for a in (x, h, n, choice)]
    p, bl = vemit.vertical_emit_rows(*t, cfg)
    assert np.array_equal(p.numpy().view(np.uint32), np.asarray(enc.payload))
    assert np.array_equal(bl.numpy(), np.asarray(enc.bit_len))
    # the default emission is the x form
    xt, ht, nt, ct = t
    p2, bl2 = encode.emit_blocks(xt, nt, ht, ct, torch.zeros_like(ct), cfg, "vertical")
    assert torch.equal(p2, p) and torch.equal(bl2, bl)


def test_vertical_emit_computes_no_candidate_z(mixed_blocks, monkeypatch):
    """The default VERTICAL emission is K3's x form: it runs neither
    ``candidate_z`` nor encode's region assembly, which the staged branch
    still runs."""
    ref_cfg, x, n, h, choice, coder, k = mixed_blocks
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    t = [torch.from_numpy(np.array(a)) for a in (x, n, h, choice, k)]
    want = encode.emit_blocks(*t, cfg, "vertical")

    def refuse(*args):
        raise AssertionError("called")

    monkeypatch.setattr(encode, "candidate_z", refuse)
    monkeypatch.setattr(encode, "assemble_rows", refuse)
    for g, w in zip(encode.emit_blocks(*t, cfg, "vertical"), want):
        assert torch.equal(g, w)
    with pytest.raises(AssertionError, match="called"):
        encode.emit_blocks(*t, cfg, "vertical", backend="pallas")
