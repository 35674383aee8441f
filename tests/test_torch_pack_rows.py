"""K5a's x form and K9's disk-order planes vs the JAX reference.

K5a's x form (``rice_pack.rice_pack_rows`` on CPU tensors, its plain twin) is
held against the reference's RICE ``emit_blocks`` (backend "xla") with
every candidate chosen block by block, and against the z form's twin on
each candidate's zigzag values. K9 (``transpose.bit_planes32``, its twin)
against ``vertical_xla.bit_transpose32`` with the planes p-major, and
against the reference's lane-reversed ``grouped_bit_transpose32`` in
interpret mode; the staged VERTICAL emission that runs it against K3's
analysis and the reference's rows. Tolerance: exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import encode as ref_encode
from dctpu.config import CodecConfig as RefConfig
from dctpu.config import LpcTable as RefLpcTable
from dctpu.kernels.transpose_pallas import grouped_bit_transpose32 as ref_k9
from dctpu.kernels.vertical_xla import bit_transpose32 as ref_bit_transpose32
from dctpu.kernels.vertical_xla import encode_vertical as ref_encode_vertical
from dctpu_torch.codec import encode
from dctpu_torch.config import DEFAULT_LPC_TABLES, from_reference
from dctpu_torch.kernels import rice_pack, transpose, vemit
from tests.test_torch_exc_transpose import _words
from tests.test_torch_vemit import WRAP, _emit_inputs, _x_inputs


def _rice_inputs(rng, L):
    """_x_inputs at 31 blocks (n = L, 0, 1, 128 and L - 57 among them),
    block i choosing candidate i % 7 of the default tables plus the wrap
    table, at k = i: every k in 0..30. The random rows escape at small k."""
    x, h, n = _x_inputs(rng, L, B=31)
    ref_cfg = RefConfig(
        block_len=L, coder="rice",
        lpc_tables=tuple(RefLpcTable(t.order, t.coeffs) for t in DEFAULT_LPC_TABLES)
        + (RefLpcTable(4, WRAP),),
    )
    blocks = np.arange(x.shape[0])
    choice = (blocks % len(ref_cfg.candidates())).astype(np.int32)
    k = blocks.astype(np.int32)
    return ref_cfg, x, h, n, choice, k


@pytest.mark.parametrize("L", [256, 300, 4096])
def test_rows_x_form_matches_reference(rng, L):
    """K5a's x form == the reference's RICE emit_blocks rows and bit_len;
    the RICE emission is the x form under every packer name."""
    ref_cfg, x, h, n, choice, k = _rice_inputs(rng, L)
    enc = ref_encode.emit_blocks(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), jnp.asarray(choice),
        jnp.asarray(k), ref_cfg, "rice", "xla",
    )
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    xt, ht, nt, ct, kt = (torch.from_numpy(a) for a in (x, h, n, choice, k))
    p, bl = rice_pack.rice_pack_rows(xt, ht, nt, ct, kt, cfg)
    assert p.dtype == torch.int32 and bl.dtype == torch.int64
    assert p.shape == (x.shape[0], rice_pack.padded_words(L))
    assert np.array_equal(p.numpy().view(np.uint32), np.asarray(enc.payload))
    assert np.array_equal(bl.numpy(), np.asarray(enc.bit_len))
    assert bl[7] == 48 * n[7]  # a random row at k = 7: every codeword escapes
    for backend in encode.RICE_PACK_BACKENDS:
        got = encode.emit_blocks(xt, nt, ht, ct, kt, cfg, "rice", backend)
        assert torch.equal(got[0], p) and torch.equal(got[1], bl)


@pytest.mark.parametrize("L", [256, 300])
def test_rows_x_form_equals_z_form(rng, L):
    """Each block's x-form row == the z form's row of its candidate's
    zigzag values (encode.candidate_z)."""
    ref_cfg, x, h, n, choice, k = _rice_inputs(rng, L)
    cfg = from_reference(dataclasses.asdict(ref_cfg))
    xt, ht, nt, ct, kt = (torch.from_numpy(a) for a in (x, h, n, choice, k))
    p, bl = rice_pack.rice_pack_rows(xt, ht, nt, ct, kt, cfg)
    for ci in range(len(cfg.candidates())):
        pz, blz = rice_pack.rice_pack(encode.candidate_z(xt, ht, cfg, ci), kt, nt, L)
        rows = ct == ci
        assert rows.any()
        assert torch.equal(p[rows], pz[rows]) and torch.equal(bl[rows], blz[rows])


@pytest.mark.parametrize("R", [70, 3])
def test_k9_disk_order_twin_matches_reference(rng, R):
    """K9's twin == bit_transpose32 with the planes p-major (the swapaxes of
    vertical_xla.encode_vertical), and == the TPU kernel's lane-reversed
    output in interpret mode once reversed and made p-major."""
    x = _words(rng, R)  # [R, 4, 32] u32
    got = transpose.bit_planes32(torch.from_numpy(x.reshape(R, 128).view(np.int32)))
    assert got.shape == (R, 128) and got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    want = np.swapaxes(np.asarray(ref_bit_transpose32(jnp.asarray(x))), 1, 2)
    assert np.array_equal(got, want.reshape(R, 128))
    xr = np.ascontiguousarray(x[..., ::-1].reshape(R, 128))
    tpu = np.asarray(ref_k9(jnp.asarray(xr), interpret=True, tr=64))
    tpu = tpu.reshape(R, 4, 32)[..., ::-1]  # rev . K9 . rev: the transpose
    assert np.array_equal(got, np.swapaxes(tpu, 1, 2).reshape(R, 128))
    assert not got[0].any() and (got[1] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("L", [256, 200, 4096])
def test_staged_emission_unchanged(rng, L, monkeypatch):
    """The staged VERTICAL analysis (K9's planes, the width rule, K8) ==
    K3's analysis, its rows == the reference's encode_vertical rows, and
    it flips nothing."""
    z, n = _emit_inputs(rng, L)
    zt, nt = torch.from_numpy(z.view(np.int32)), torch.from_numpy(n)
    want = vemit.vertical_emit(zt, nt, L)

    def refuse(*args, **kwargs):
        raise AssertionError("flip in the staged emission")

    monkeypatch.setattr(torch.Tensor, "flip", refuse)
    monkeypatch.setattr(torch, "flip", refuse)
    got = encode._emit_staged(zt, nt, L)
    p, bl = encode.encode_vertical(zt, nt, L, "pallas")
    monkeypatch.undo()
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))
    p_ref, bl_ref = ref_encode_vertical(
        jnp.asarray(z), jnp.asarray(n), L, exc_backend="xla"
    )
    assert np.array_equal(p.numpy().view(np.uint32), np.asarray(p_ref))
    assert np.array_equal(bl.numpy(), np.asarray(bl_ref))
