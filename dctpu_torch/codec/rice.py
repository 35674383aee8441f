"""Zigzag and Golomb-Rice codeword math (FORMAT §2, §4) on torch tensors.

The counterpart of ``dctpu/codec/rice.py``. zigzag values travel as int32
bit patterns; the arithmetic on them runs on int64 u32 values (see
``dctpu_torch/_bits.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dctpu_torch._bits import to_i32, to_u32
from dctpu_torch.constants import ESCAPE_Q, K_MAX, MAX_CODE_BITS


def zigzag(r: torch.Tensor) -> torch.Tensor:
    """int32 residuals -> zigzag u32 values as int32 bit patterns."""
    r64 = r.to(torch.int32).to(torch.int64)
    return to_i32((r64 << 1) ^ (r64 >> 31))


def unzigzag(z: torch.Tensor) -> torch.Tensor:
    """zigzag u32 bit patterns -> int32 residuals."""
    u = to_u32(z)
    return to_i32((u >> 1) ^ -(u & 1))


def code_lengths(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Codeword bit lengths, int64; k broadcasts against z."""
    q = to_u32(z) >> k.to(torch.int64)
    return torch.where(q >= ESCAPE_Q, MAX_CODE_BITS, q + 1 + k.to(torch.int64))


def rice_totals(z: torch.Tensor, n: torch.Tensor, k_max: int) -> torch.Tensor:
    """Exact RICE coded bits per block and k, [B, k_max + 1] int64.

    L(k) = sum over the valid samples of (q < 16 ? q + 1 + k : 48) with
    q = z >> k (FORMAT §4): one pass per k. The same integers as the plane
    identity of ``dctpu.codec.rice.choose_k_planes``."""
    L = z.shape[1]
    valid = torch.arange(L, device=z.device)[None, :] < n.to(torch.int64)[:, None]
    u = to_u32(z)
    out = []
    for k in range(k_max + 1):
        q = u >> k
        ln = torch.where(q >= ESCAPE_Q, MAX_CODE_BITS, q + 1 + k)
        out.append(torch.where(valid, ln, 0).sum(1))
    return torch.stack(out, dim=1)


def choose_k(
    z: torch.Tensor, valid: torch.Tensor, k_max: int = K_MAX
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact argmin over k of the coded bits of the valid samples: z and
    the mask valid [..., L] -> (k, bits) int32 [...], ties to the smallest
    k (the reference's choose_k). Raises ValueError where the reference
    asserts (k past 5 bits, or totals * 32 past int31)."""
    L = z.shape[-1]
    if not 0 <= k_max < 32:
        raise ValueError(f"k_max must be in [0, 32), got {k_max}")
    if L * MAX_CODE_BITS >= 2**26:
        raise ValueError(f"block_len {L} too large for the packed key")
    totals = torch.stack(
        [torch.where(valid, code_lengths(z, torch.tensor(k)), 0).sum(-1)
         for k in range(k_max + 1)],
        dim=-1,
    )
    k, bits = best_k(totals)
    return k.to(torch.int32), bits.to(torch.int32)


def best_k(totals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K+1] totals -> (k, bits) int64: argmin with ties to the smallest
    k, as one packed (totals*32 + k) minimum."""
    ks = torch.arange(totals.shape[-1], device=totals.device)
    key = (totals.to(torch.int64) * 32 + ks).min(-1).values
    return key & 31, key >> 5


def choose_k_planes(
    z: torch.Tensor, n: torch.Tensor, k_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-block (k, bits) — the contract of the reference's
    choose_k_planes (and choose_k), from :func:`rice_totals`."""
    return best_k(rice_totals(z, n, k_max))


def choose_k_auto(
    z: torch.Tensor, n: torch.Tensor, block_len: int, k_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-block (k, bits) of one candidate's zigzag values, the
    reference's contract, from K6's z form (``kernels/rice_totals.py``):
    the kernel on a CUDA device, its plain twin on the CPU. Raises
    ValueError for k_max > 24, where the reference asserts. The encode
    takes the same totals from K6's x forms (``encode.select_blocks``)."""
    from dctpu_torch.kernels.rice_totals import rice_totals as k6

    return best_k(k6(z, n, block_len, k_max))


def codewords(z: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code int64, length int64) per sample; k broadcasts against z.

    The codeword integer (bit 0 = first stream bit), at most 48 bits:
      normal: ((1<<q)-1) | (low_k(z) << (q+1)),  len = q+1+k  (q < 16)
      escape: 0xFFFF | (z << 16),                len = 48
    """
    u = to_u32(z)
    k = k.to(torch.int64)
    q = u >> k
    esc = q >= ESCAPE_Q
    qe = torch.clamp(q, max=ESCAPE_Q - 1)
    normal = ((1 << qe) - 1) | ((u & ((1 << k) - 1)) << (qe + 1))
    code = torch.where(esc, 0xFFFF | (u << 16), normal)
    return code, code_lengths(z, k)
