"""K5a: RICE bit packer, one dense u32 payload row per block.

The counterpart of ``dctpu/kernels/attic/pack_pallas.py`` (``pack_pallas``,
with the codewords, sync table and bit_len its wrapper formed in XLA
around the kernel). The CUDA kernel (``dctpu_torch/csrc/pack.cu``) forms
each codeword itself and writes the rows and bit lengths of
``encode.emit_blocks(..., coder="rice")`` in one launch per coder group,
in three forms:

  * :func:`rice_pack_rows`, the x form: it derives each block's chosen
    candidate's residuals from the raw samples, as K3's x form does; every
    RICE emission runs it;
  * :func:`rice_pack`, the z form, on zigzag values;
  * :func:`rice_pack_codes`, the codes form, on the codewords themselves
    (low and high words, lengths, a validity mask): the reference's
    ``kernels/api.pack`` contract, which ``kernels/api.py`` ports.

The z form's plain twin is ``rice.codewords`` followed by
:func:`pack_plain`, the ``dctpu/kernels/pack_xla.py`` formulation, which is
also the codes form's twin:

  1. exclusive prefix sum of the code lengths: every sample's bit offset;
  2. per-128-sample length sums: the payload's leading sync table;
  3. each codeword (<= 48 bits) at any bit offset spans at most 3 words,
     so it splits into 3 word contributions;
  4. contributions of different codewords hold disjoint bits, so an
     ``index_add_`` into int64 words equals the OR.

Each wrapper runs its plain torch twin for tensors on the CPU and launches
the kernel for tensors on a CUDA device; its ``launches`` attribute counts
the kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dctpu_torch._bits import MASK32, to_i32, to_u32
from dctpu_torch.codec import predict, rice
from dctpu_torch.constants import (
    MAX_CODE_BITS,
    SUB_BLOCK,
    subs_per_block,
    sync_words,
)
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.args import candidate_table, check_x, rows_out


def padded_words(block_len: int) -> int:
    """Worst-case payload words per block (sync table + all-escape stream)."""
    return sync_words(block_len) + (block_len * MAX_CODE_BITS + 31) // 32


def make_sync_table(length: torch.Tensor, block_len: int) -> torch.Tensor:
    """[B, L] code bit lengths -> [B, sync_words] u32 values (int64)."""
    B, L = length.shape
    S = subs_per_block(block_len)
    pad = S * SUB_BLOCK - L
    lens = torch.nn.functional.pad(length, (0, pad)) if pad else length
    sub_lens = lens.reshape(B, S, SUB_BLOCK).sum(2)
    if S % 2:
        sub_lens = torch.nn.functional.pad(sub_lens, (0, 1))
    pairs = sub_lens.reshape(B, -1, 2)
    return pairs[:, :, 0] | (pairs[:, :, 1] << 16)


def pack_plain(
    code: torch.Tensor,    # [B, L] int64 codewords (< 2**48)
    length: torch.Tensor,  # [B, L] int64 code lengths
    valid: torch.Tensor,   # [B, L] bool
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (payload [B, W] int32 bit patterns incl. sync table,
    bit_len [B] int64)."""
    B, L = code.shape
    Wbits = padded_words(block_len) - sync_words(block_len)
    length = torch.where(valid, length, 0)
    code = torch.where(valid, code, 0)

    incl = torch.cumsum(length, dim=1)
    off = incl - length
    bit_len = incl[:, -1]
    sync = make_sync_table(length, block_len)

    s = off & 31
    w = off >> 5
    v0 = ((code & MASK32) << s) & MASK32
    v1 = (code >> (32 - s)) & MASK32
    v2 = code >> (64 - s).clamp(max=63)  # code < 2**48: 0 unless s > 16
    base = (torch.arange(B, device=code.device)[:, None] * Wbits + w).reshape(-1)
    # +2 words of slack: a codeword's contributions past its own words are 0
    bits = torch.zeros(B * Wbits + 2, dtype=torch.int64, device=code.device)
    for j, v in enumerate((v0, v1, v2)):
        bits.index_add_(0, base + j, v.reshape(-1))
    payload = torch.cat([sync, bits[: B * Wbits].reshape(B, Wbits)], dim=1)
    return to_i32(payload), bit_len


def rice_pack_plain(z, k, n, block_len: int):
    """Plain twin of K5a: the codewords, then :func:`pack`."""
    L = z.shape[1]
    valid = torch.arange(L, device=z.device)[None, :] < n.to(torch.int64)[:, None]
    code, length = rice.codewords(z, k.to(torch.int64)[:, None])
    return pack_plain(code, length, valid, block_len)


def rice_pack(
    z: torch.Tensor,  # [B, L] int32 zigzag bit patterns (garbage past n)
    k: torch.Tensor,  # [B] Rice k, in [0, 30]
    n: torch.Tensor,  # [B] valid counts
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5a, z form: (payload [B, padded_words(L)] int32 bit patterns incl.
    sync table, bit_len [B] int64) -- the contract of :func:`pack`."""
    if z.device.type == "cpu":
        return rice_pack_plain(z, k, n, block_len)
    if z.device.type != "cuda":
        raise ValueError(f"rice_pack: unsupported device {z.device}")
    k = k.to(torch.int32).contiguous()
    n = n.to(torch.int32).contiguous()
    _build.check_tensors("rice_pack", z, k, n)
    B, L = z.shape
    if L != block_len or k.shape != (B,) or n.shape != (B,):
        raise ValueError("rice_pack: expects z [B, block_len], k [B], n [B]")
    payload, bit_len = rows_out(B, L, padded_words(L), z.device)
    if B:
        _build.launch(
            "dct_rice_pack", z,
            z.data_ptr(), k.data_ptr(), n.data_ptr(), payload.data_ptr(),
            bit_len.data_ptr(), B, L, payload.shape[1],
        )
        rice_pack.launches += 1
    return payload, bit_len


rice_pack.launches = 0


def rice_pack_rows_plain(x, history, n, choice, k, cfg):
    """Plain twin of K5a's x form: each block's chosen candidate's zigzag
    residuals, then the z form's twin."""
    r = predict.chosen_residuals(x, history, choice, predict.candidate_coeffs(cfg))
    return rice_pack_plain(rice.zigzag(r), k, n, x.shape[1])


def rice_pack_rows(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    choice: torch.Tensor,   # [B] index into cfg.candidates()
    k: torch.Tensor,        # [B] Rice k, in [0, 30]
    cfg,                    # the CodecConfig whose candidates choice indexes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5a, x form: the RICE payload rows of each block's chosen candidate
    at its k, the residuals derived from x in the kernel.

    Returns (payload [B, padded_words(L)] int32 bit patterns incl. sync
    table, bit_len [B] int64). Raises ValueError for an LPC coefficient
    outside int32, the frame's type."""
    table = candidate_table(cfg, x.device)
    if x.device.type == "cpu":
        return rice_pack_rows_plain(x, history, n, choice, k, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"rice_pack_rows: unsupported device {x.device}")
    n = check_x("rice_pack_rows", x, history, n, cfg.block_len)
    choice = choice.to(torch.int32).contiguous()
    k = k.to(torch.int32).contiguous()
    _build.check_tensors("rice_pack_rows", x, choice, k)
    B, L = x.shape
    if choice.shape != (B,) or k.shape != (B,):
        raise ValueError("rice_pack_rows: expects choice [B], k [B]")
    payload, bit_len = rows_out(B, L, padded_words(L), x.device)
    if B:
        _build.launch(
            "dct_rice_pack_rows", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), k.data_ptr(),
            choice.data_ptr(), table.data_ptr(), table.shape[0],
            payload.data_ptr(), bit_len.data_ptr(), B, L, payload.shape[1],
        )
        rice_pack_rows.launches += 1
    return payload, bit_len


rice_pack_rows.launches = 0


def rice_pack_codes_plain(code_lo, code_hi, length, valid, block_len: int):
    """Plain twin of K5a's codes form: each codeword as one int64, then
    :func:`pack_plain`."""
    code = to_u32(code_lo) | (to_u32(code_hi) << 32)
    return pack_plain(code, length.to(torch.int64), valid, block_len)


def rice_pack_codes(
    code_lo: torch.Tensor,  # [B, L] bits 0..31 of each codeword (int32 bit patterns)
    code_hi: torch.Tensor,  # [B, L] bits 32.. of each codeword
    length: torch.Tensor,   # [B, L] code lengths, <= 48
    valid: torch.Tensor,    # [B, L] bool: the samples that are coded
    block_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5a, codes form: (payload [B, padded_words(L)] int32 bit patterns
    incl. sync table, bit_len [B] int64) of the codewords, each at the bit
    offset that the lengths before it give; an invalid sample's length
    counts as 0. No codeword may have a bit set at or above its length,
    as ``rice.codewords`` gives them."""
    if code_lo.device.type == "cpu":
        return rice_pack_codes_plain(code_lo, code_hi, length, valid, block_len)
    if code_lo.device.type != "cuda":
        raise ValueError(f"rice_pack_codes: unsupported device {code_lo.device}")
    code_lo, code_hi, length = (
        t.to(torch.int32).contiguous() for t in (code_lo, code_hi, length)
    )
    valid = valid.to(torch.bool).contiguous()
    _build.check_tensors("rice_pack_codes", code_lo, code_hi, length)
    B, L = code_lo.shape
    if (L != block_len or code_hi.shape != (B, L) or length.shape != (B, L)
            or valid.shape != (B, L) or valid.device != code_lo.device):
        raise ValueError(
            "rice_pack_codes: expects code_lo, code_hi, length and valid "
            "[B, block_len] on one device"
        )
    payload, bit_len = rows_out(B, L, padded_words(L), code_lo.device)
    if B:
        _build.launch(
            "dct_rice_pack_codes", code_lo,
            code_lo.data_ptr(), code_hi.data_ptr(), length.data_ptr(),
            valid.data_ptr(), payload.data_ptr(), bit_len.data_ptr(), B, L,
            payload.shape[1],
        )
        rice_pack_codes.launches += 1
    return payload, bit_len


rice_pack_codes.launches = 0
