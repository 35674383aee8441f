"""The port's block-batch codec and kernel-level API vs the JAX reference.

``encode.encode_blocks`` / ``emit_blocks_body`` and ``decode.decode_blocks``
against the reference's ``encode_blocks(..., "xla")`` and
``decode_blocks(..., backend="xla")`` on its own rows; the four sharded
block functions over two CPU devices against one; ``kernels.pack`` /
``unpack`` / ``pack_xla`` / ``unpack_xla`` and ``DCTPU_KERNEL_BACKEND``;
``rice.choose_k`` and the predict helpers. Inputs: the streams of
``tests/conftest.stream_cases``, block lengths 128, 300 and 4096, every
default candidate, Rice k 0..30. Integer codec: exact equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctpu.codec import predict as ref_predict
from dctpu.codec import rice as ref_rice
from dctpu.codec.decode import decode_blocks as ref_decode_blocks
from dctpu.codec.encode import emit_blocks as ref_emit_blocks
from dctpu.codec.encode import encode_blocks as ref_encode_blocks
from dctpu.config import CodecConfig as RefConfig
from dctpu.kernels import api as ref_kernels
from dctpu.kernels import pack_xla as ref_pack_xla
from dctpu.kernels import padded_words as ref_padded_words
from dctpu.kernels import unpack_xla as ref_unpack_xla
from dctpu_torch import kernels
from dctpu_torch.codec import api, decode, encode, predict, rice
from dctpu_torch.config import from_reference
from dctpu_torch.dist import sharded
from dctpu_torch.dist import decode_blocks_sharded, encode_blocks_sharded
from tests.conftest import stream_cases

LENS = (128, 300, 4096)
# (coder, block length) of the encode and decode comparisons: each block
# length under each coder group, to bound the reference's compiles (about
# 10 s each on a cold cache); the reference's encode_blocks takes its RICE
# branch for "adaptive"
DECODE_CASES = [("rice", 128), ("rice", 4096), ("vertical", 300), ("vertical", 4096)]
ENCODE_CASES = DECODE_CASES + [("adaptive", 128)]
TWO_CPUS = [torch.device("cpu")] * 2
REF_PACK = jax.jit(ref_kernels.pack, static_argnums=(4, 5))
REF_UNPACK_XLA = jax.jit(ref_unpack_xla, static_argnums=3)


def _cfgs(coder, L):
    ref_cfg = RefConfig(block_len=L, coder=coder)
    return ref_cfg, from_reference(dataclasses.asdict(ref_cfg))


def _blocks(L):
    """The stream cases' blocks (x, n, history) as numpy arrays."""
    x, n, h, _, _ = api.build_blocks(stream_cases(np.random.default_rng(1234)), L)
    return x, n, h


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _u32(t) -> np.ndarray:
    """A port tensor of u32 bit patterns (or plain ints) as uint32."""
    return np.asarray(t.to(torch.int64)).astype(np.uint32)


def _same_fields(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, name
        assert np.array_equal(_u32(g), w.astype(np.uint32)), name


@pytest.fixture(scope="module")
def ref_encoded():
    """(coder, L) -> the reference's EncodedBlocks of the stream cases."""
    out = {}
    for coder, L in ENCODE_CASES:
        x, n, h = _blocks(L)
        out[coder, L] = ref_encode_blocks(
            jnp.asarray(x), jnp.asarray(n), jnp.asarray(h),
            _cfgs(coder, L)[0], "xla")
    return out


@pytest.mark.parametrize("coder, L", ENCODE_CASES)
def test_encode_blocks_equals_reference(ref_encoded, coder, L):
    """encode_blocks equals the reference's, field by field; for "adaptive"
    both take the RICE branch. The reference's *_body names are the same
    functions."""
    cfg = _cfgs(coder, L)[1]
    got = encode.encode_blocks(*_t(*_blocks(L)), cfg)
    _same_fields(got, ref_encoded[coder, L])
    assert set(np.asarray(got.predictor).tolist()) == {0, 1, 2}
    assert encode.encode_blocks_body is encode.encode_blocks
    assert encode.adaptive_select_body is encode.adaptive_select


@pytest.mark.parametrize("coder", ["rice", "vertical"])
def test_emit_blocks_body_equals_reference(coder):
    """A forced selection of every candidate (and every k, for RICE)
    through emit_blocks_body equals the reference's emit_blocks."""
    L = 300
    ref_cfg, cfg = _cfgs("adaptive", L)
    x, n, h = _blocks(L)
    B = x.shape[0]
    choice = (np.arange(B) % len(cfg.candidates())).astype(np.int32)
    k = (np.arange(B) % 31).astype(np.int32)
    want = ref_emit_blocks(*(jnp.asarray(a) for a in (x, n, h, choice, k)),
                           ref_cfg, coder, "xla")
    _same_fields(encode.emit_blocks_body(*_t(x, n, h, choice, k), cfg, coder),
                 want)


def _ref_rows(enc, coder):
    """The reference's decode rows: RICE with 2 zero words after each row."""
    p = np.asarray(enc.payload)
    if coder == "vertical":
        return p
    return np.concatenate([p, np.zeros((p.shape[0], 2), np.uint32)], axis=1)


def _decode_args(enc, n, h, cfg):
    tables = np.array([t.coeffs for t in cfg.lpc_tables], np.int64)
    return (np.asarray(enc.k), n, np.asarray(enc.predictor),
            np.asarray(enc.table_idx), h, tables)


@pytest.mark.parametrize("coder, L", DECODE_CASES)
def test_decode_blocks_equals_reference(ref_encoded, coder, L):
    """decode_blocks on the reference's rows equals the reference's
    decode_blocks(backend="xla") and the input, zeros past n."""
    x, n, h = _blocks(L)
    cfg = _cfgs(coder, L)[1]
    enc = ref_encoded[coder, L]
    rows = _ref_rows(enc, coder)
    args = _decode_args(enc, n, h, cfg)
    want = np.asarray(ref_decode_blocks(
        jnp.asarray(rows), *(jnp.asarray(a) for a in args), L, True,
        backend="xla", coder=coder))
    got = decode.decode_blocks(
        torch.from_numpy(rows.view(np.int32)), *_t(*args), L, True, coder=coder)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(got.numpy(), np.where(valid, x, 0))
    assert decode.decode_blocks_body is decode.decode_blocks


def test_decode_blocks_without_lpc_follows_reference(ref_encoded):
    """has_lpc=False: LPC blocks decode as DOUBLE_DELTA, as there."""
    L = 128
    x, n, h = _blocks(L)
    enc = ref_encoded["rice", L]
    assert (np.asarray(enc.predictor) == 2).any()
    rows = _ref_rows(enc, "rice")
    args = _decode_args(enc, n, h, _cfgs("rice", L)[1])
    want = np.asarray(ref_decode_blocks(
        jnp.asarray(rows), *(jnp.asarray(a) for a in args), L, False,
        backend="xla"))
    got = decode.decode_blocks(torch.from_numpy(rows.view(np.int32)),
                               *_t(*args), L, False)
    assert np.array_equal(got.numpy(), want)


def test_decode_blocks_refuses_rows_outside_the_contract(ref_encoded):
    """A VERTICAL row wider than max_planes, or with a malformed sync
    entry, raises ValueError; a RICE call raises for a backend name the
    reference's unpack does not know, and a VERTICAL one does not."""
    L = 300
    x, n, h = _blocks(L)
    enc = ref_encoded["vertical", L]
    rows = _ref_rows(enc, "vertical").view(np.int32).copy()
    args = _t(*_decode_args(enc, n, h, _cfgs("vertical", L)[1]))
    sync = rows[:, :2].view(np.uint32)  # three sub-blocks' entries
    widest = int(max((sync & 0x3F).max(), ((sync >> 16) & 0x3F)[:, 0].max()))
    with pytest.raises(ValueError, match="max_planes"):
        decode.decode_blocks(torch.from_numpy(rows), *args, L, True,
                             coder="vertical", max_planes=widest - 1)
    decode.decode_blocks(torch.from_numpy(rows), *args, L, True,
                         backend="no_such_backend", coder="vertical",
                         max_planes=widest)
    bad = rows.copy()
    bad[3, 0] = (bad[3, 0] & -(1 << 16)) | 40  # sub 0: b = 40
    with pytest.raises(ValueError, match="sync table"):
        decode.decode_blocks(torch.from_numpy(bad), *args, L, True,
                             coder="vertical")
    L = 128
    _, n, h = _blocks(L)
    rice_enc = ref_encoded["rice", L]
    rice_rows = torch.from_numpy(_ref_rows(rice_enc, "rice").view(np.int32))
    rice_args = _t(*_decode_args(rice_enc, n, h, _cfgs("rice", L)[1]))
    for name in ("merge", "no_such_backend"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            ref_kernels.unpack(None, None, None, L, name)
        with pytest.raises(ValueError, match="unknown kernel backend"):
            decode.decode_blocks(rice_rows, *rice_args, L, True, backend=name)


@pytest.mark.parametrize("B", [5, None])
def test_sharded_block_functions_equal_one_device(B):
    """The four sharded block functions over two CPU devices, on B blocks
    that the mesh does not divide (5) and on all of them, equal the
    single-device functions."""
    L = 128
    x, n, h = _t(*_blocks(L))
    x, n, h = x[:B], n[:B], h[:B]
    for coder in ("rice", "vertical"):
        cfg = _cfgs(coder, L)[1]
        enc = encode.encode_blocks(x, n, h, cfg)
        got = encode_blocks_sharded(x, n, h, cfg, TWO_CPUS)
        for g, w in zip(got, enc):
            assert torch.equal(g, w)
        tables = [t.coeffs for t in cfg.lpc_tables]
        args = (enc.k, n, enc.predictor, enc.table_idx, h, tables, L, True)
        want = decode.decode_blocks(enc.payload, *args, coder=coder)
        assert torch.equal(
            decode_blocks_sharded(enc.payload, *args[:-2], L, True, TWO_CPUS,
                                  coder=coder), want)
    cfg = _cfgs("adaptive", L)[1]
    sel = encode.adaptive_select(x, n, h, cfg)
    for g, w in zip(sharded.adaptive_select_sharded(x, n, h, cfg, TWO_CPUS), sel):
        assert torch.equal(g, w)
    choice, _, k = sel
    for coder in ("rice", "vertical"):
        want = encode.emit_blocks_body(x, n, h, choice, k, cfg, coder)
        got = sharded.emit_blocks_sharded(x, n, h, choice, k, cfg, coder, TWO_CPUS)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _codewords(L, seed):
    """The reference's codewords of seeded zigzag values at k = b % 31 on
    block b, with a validity mask that leaves out a prefix, a ragged tail
    and scattered samples."""
    rng = np.random.default_rng(seed)
    B = 40
    z = (rng.geometric(0.01, size=(B, L)) - 1).astype(np.uint32)
    z[0, :17] = 0xFFFFFFFF
    z[1] = rng.integers(0, 2**32, size=L, dtype=np.uint64).astype(np.uint32)
    k = (np.arange(B) % 31).astype(np.int32)
    valid = np.arange(L)[None, :] < rng.integers(0, L + 1, size=B)[:, None]
    valid[2] = rng.random(L) < 0.5
    valid[3] = True
    lo, hi, length = (np.asarray(a) for a in
                      ref_rice.codewords(jnp.asarray(z), jnp.asarray(k)[:, None]))
    return z, k, valid, lo, hi, length


@pytest.mark.parametrize("L", LENS)
def test_pack_and_unpack_equal_reference(L):
    """kernels.pack / pack_xla equal the reference's pack (every name it
    knows) and pack_xla; unpack / unpack_xla on the rows with 2 zero words
    equal the reference's unpack(backend="xla") and unpack_xla."""
    z, k, valid, lo, hi, length = _codewords(L, seed=L)
    ref = [np.asarray(a) for a in REF_PACK(
        *(jnp.asarray(a) for a in (lo, hi, length, valid)), L, "xla")]
    if L == LENS[0]:  # the reference's own two packers agree
        ref_x = [np.asarray(a) for a in jax.jit(ref_pack_xla, static_argnums=4)(
            *(jnp.asarray(a) for a in (lo, hi, length, valid)), L)]
        assert all(np.array_equal(a, b) for a, b in zip(ref, ref_x))
    args = (torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32)),
            torch.from_numpy(length), torch.from_numpy(valid))
    for fn in (kernels.pack, kernels.pack_xla):
        payload, bit_len = fn(*args, L)
        assert payload.shape == (z.shape[0], kernels.padded_words(L))
        assert bit_len.dtype == torch.int32
        assert np.array_equal(_u32(payload), ref[0])
        assert np.array_equal(bit_len.numpy(), ref[1])
    for name in ("auto", "scan", "merge", "scatter", "pallas"):
        assert torch.equal(kernels.pack(*args, L, name)[0], payload)
    assert kernels.padded_words(L) == ref_padded_words(L)

    rows = np.concatenate([ref[0], np.zeros((ref[0].shape[0], 2), np.uint32)], 1)
    n = np.where(valid[:, ::-1].any(1), L - np.argmax(valid[:, ::-1], 1), 0)
    n[2:4] = L  # the rows whose mask is not a prefix: decode every sample
    n = n.astype(np.int32)
    # the reference's unpack(backend="xla") is its unpack_xla
    want = np.asarray(REF_UNPACK_XLA(*(jnp.asarray(a) for a in (rows, k, n)), L))
    t_rows, t_k, t_n = _t(rows.view(np.int32), k, n)
    for name in ("auto", "scan", "scan_xla", "xla", "pallas"):
        assert np.array_equal(_u32(kernels.unpack(t_rows, t_k, t_n, L, name)), want)
    assert np.array_equal(_u32(kernels.unpack_xla(t_rows, t_k, t_n, L)), want)
    live = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(want[4:], np.where(live, z, 0)[4:])


def test_kernel_backend_env_is_honoured(monkeypatch):
    """backend=None reads DCTPU_KERNEL_BACKEND in both packages; a name the
    reference does not know raises in both, where the reference raises."""
    L = 128
    _, k, valid, lo, hi, length = _codewords(L, seed=7)
    args = (torch.from_numpy(lo.view(np.int32)), torch.from_numpy(hi.view(np.int32)),
            torch.from_numpy(length), torch.from_numpy(valid))
    monkeypatch.delenv("DCTPU_KERNEL_BACKEND", raising=False)
    assert kernels.api.default_backend() == ref_kernels.default_backend() == "auto"
    want = kernels.pack(*args, L)
    rows = torch.cat([want[0], torch.zeros((want[0].shape[0], 2), dtype=torch.int32)], 1)
    n = torch.full((rows.shape[0],), L, dtype=torch.int32)
    kk = torch.from_numpy(k)
    for env, pack_ok, unpack_ok in (("scatter", True, False), ("merge", True, False),
                                    ("reduce", False, False), ("scan_xla", False, True)):
        monkeypatch.setenv("DCTPU_KERNEL_BACKEND", env)
        assert kernels.api.default_backend() == ref_kernels.default_backend() == env
        for ok, port_call, ref_call in (
            (pack_ok, lambda: kernels.pack(*args, L),
             lambda: ref_kernels.pack(None, None, None, None, L)),
            (unpack_ok, lambda: kernels.unpack(rows, kk, n, L),
             lambda: ref_kernels.unpack(None, None, None, L)),
        ):
            if ok:
                port_call()
                continue
            for call in (port_call, ref_call):
                with pytest.raises(ValueError, match="unknown kernel backend"):
                    call()
        # an explicit name wins over the variable
        assert torch.equal(kernels.pack(*args, L, "auto")[0], want[0])


@pytest.mark.parametrize("k_max", [0, 7, 24, 31])
def test_choose_k_equals_reference(k_max):
    rng = np.random.default_rng(k_max)
    z = (rng.geometric(0.002, size=(3, 5, 300)) - 1).astype(np.uint32)
    z[0, 0, :40] = 0xFFFFFFFF
    valid = rng.random((3, 5, 300)) < 0.8
    want = ref_rice.choose_k(jnp.asarray(z), jnp.asarray(valid), k_max)
    got = rice.choose_k(torch.from_numpy(z.view(np.int32)),
                        torch.from_numpy(valid), k_max)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_choose_k_raises_where_the_reference_asserts():
    z = torch.zeros((2, 128), dtype=torch.int32)
    valid = torch.ones((2, 128), dtype=torch.bool)
    with pytest.raises(AssertionError):
        ref_rice.choose_k(jnp.zeros((2, 128), jnp.uint32), jnp.ones((2, 128), bool), 32)
    with pytest.raises(ValueError, match="k_max"):
        rice.choose_k(z, valid, 32)
    with pytest.raises(ValueError, match="too large"):
        rice.choose_k(torch.zeros((1, 2**21), dtype=torch.int32),
                      torch.ones((1, 2**21), dtype=torch.bool))


@pytest.mark.parametrize("L", LENS)
def test_predict_helpers_equal_reference(L):
    """lpc_predict_encode for each default table and one whose products
    wrap the int64 accumulator, and all_candidate_residuals."""
    ref_cfg, cfg = _cfgs("adaptive", L)
    x, _, h = _blocks(L)
    x[0, :9] = np.int32(-(2**31))
    h[0] = -(2**31)
    tables = [t.coeffs for t in cfg.lpc_tables] + [(-(2**31),) * 4]
    for coeffs in tables:
        want = ref_predict.lpc_predict_encode(jnp.asarray(x), jnp.asarray(h), coeffs)
        got = predict.lpc_predict_encode(*_t(x, h), coeffs)
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = ref_predict.all_candidate_residuals(jnp.asarray(x), jnp.asarray(h), ref_cfg)
    got = predict.all_candidate_residuals(*_t(x, h), cfg)
    assert got.shape == (len(cfg.candidates()), *x.shape)
    assert np.array_equal(got.numpy(), np.asarray(want))
