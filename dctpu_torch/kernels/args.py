"""Kernel arguments that several wrappers share: the checks of the
raw-sample (x) forms (K1, K2, K3, K5a, K6), the candidate table of the x-form
emissions (K3, K5a) and the emission kernels' output rows (K3, K5a)."""

from __future__ import annotations

import functools

import torch

from dctpu_torch.codec.predict import candidate_coeffs
from dctpu_torch.constants import subs_per_block
from dctpu_torch.kernels import _build

MAX_SUBS = 512  # the emission kernels' sync table: block_len < 65536 (n is a u16)


def check_x(name, x, history, n, block_len):
    """The raw-sample forms' kernel arguments; returns n as int32."""
    n = n.to(torch.int32).contiguous()
    _build.check_tensors(name, x, history, n)
    B, L = x.shape
    if L != block_len or n.shape != (B,) or history.shape != (B, 4):
        raise ValueError(f"{name}: expects x [B, block_len], history [B, 4], n [B]")
    return n


def lpc_coeffs(coeffs) -> tuple:
    """Four Q16 coefficients as ints; ValueError unless each is int32, the
    frame's type."""
    coeffs = tuple(int(c) for c in coeffs)
    if len(coeffs) != 4 or not all(-(2**31) <= c < 2**31 for c in coeffs):
        raise ValueError(f"LPC coefficients must be four int32 values, got {coeffs}")
    return coeffs


@functools.lru_cache(maxsize=16)
def candidate_table(cfg, device: torch.device) -> torch.Tensor:
    """``cfg.candidates()`` as the x-form emission kernels' [C, 5] int32
    table: predictor, then Q16 c0..c3. ValueError for a coefficient
    outside int32, the frame's type. Cached per configuration and device:
    a copy to the card from host memory waits for the card, and would hold
    back each emission's launch."""
    return torch.tensor(
        [[p, *lpc_coeffs(c)] for p, c in candidate_coeffs(cfg)],
        dtype=torch.int32, device=device,
    )


def rows_out(B: int, block_len: int, width: int, device):
    """An emission kernel's outputs, payload rows [B, width] int32 and
    bit_len [B] int64, uninitialised; ValueError for a block_len whose sync
    table the kernels (K3, K5a) do not hold."""
    if subs_per_block(block_len) > MAX_SUBS:
        raise ValueError(f"block_len {block_len} too large for the sync table")
    return (
        torch.empty((B, width), dtype=torch.int32, device=device),
        torch.empty(B, dtype=torch.int64, device=device),
    )
