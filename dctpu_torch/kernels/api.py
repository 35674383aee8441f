"""The kernel-level RICE API: the counterpart of ``dctpu/kernels/api.py``.

``pack`` and ``unpack`` take the reference's arguments and backend names;
``backend=None`` reads ``DCTPU_KERNEL_BACKEND`` (default ``"auto"``), and a
name the reference does not know raises ValueError, as there. The names
pick among the reference's XLA and Pallas implementations of one function;
the port has one implementation of each, so every name runs it: on a CUDA
tensor K5a's codes form (``pack``) or K5b's words form (``unpack``), on a
CPU tensor their plain twins. ``pack_xla`` and ``unpack_xla`` are those
twins under the reference's names (``dctpu/kernels/pack_xla.py``,
``unpack_xla.py``).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from dctpu_torch.kernels.rice_pack import rice_pack_codes, rice_pack_codes_plain
from dctpu_torch.kernels.rice_unpack import rice_unpack_words, unpack as unpack_xla

# the reference's names (dctpu/kernels/api.py pack and unpack)
PACK_BACKENDS = ("auto", "xla", "scan", "merge", "scatter", "pallas")
UNPACK_BACKENDS = ("auto", "scan", "scan_xla", "xla", "pallas")


def default_backend() -> str:
    return os.environ.get("DCTPU_KERNEL_BACKEND", "auto")


def _check_backend(backend: str | None, known) -> None:
    backend = backend or default_backend()
    if backend not in known:
        raise ValueError(f"unknown kernel backend {backend!r}")


def pack_xla(code_lo, code_hi, length, valid, block_len: int):
    """The plain RICE packer: (payload [B, padded_words(L)] int32 bit
    patterns incl. sync table, bit_len [B] int32)."""
    payload, bit_len = rice_pack_codes_plain(code_lo, code_hi, length, valid,
                                             block_len)
    return payload, bit_len.to(torch.int32)


def pack(
    code_lo: torch.Tensor,  # [B, L] bits 0..31 of each codeword
    code_hi: torch.Tensor,  # [B, L] bits 32.. of each codeword
    length: torch.Tensor,   # [B, L] code lengths (those of invalid samples ignored)
    valid: torch.Tensor,    # [B, L] bool
    block_len: int,
    backend: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codewords of each block packed into one row: (payload
    [B, padded_words(L)] int32 bit patterns incl. sync table, bit_len [B]
    int32). One launch of K5a's codes form on a card."""
    _check_backend(backend, PACK_BACKENDS)
    payload, bit_len = rice_pack_codes(code_lo, code_hi, length, valid, block_len)
    return payload, bit_len.to(torch.int32)


def unpack(
    payload: torch.Tensor,  # [B, Wp] int32 bit patterns
    k: torch.Tensor,        # [B] Rice k
    n: torch.Tensor,        # [B] valid samples
    block_len: int,
    backend: str | None = None,
    buf_words: int = 0,
) -> torch.Tensor:
    """Pack rows -> z [B, L] zigzag values as int32 bit patterns (zeros past
    n). One launch of K5b on a card, which reads the rows in place as
    words: row b is the block at b * Wp, Wp words long; no staging copy.

    The rows are the reference's ``"xla"`` contract under every name: the
    payload of ``pack``, then at least 2 zero words. The reference's
    ``"auto"``, ``"scan"`` and ``"scan_xla"`` take ``stage_rice_scan``
    rows, a TPU staging layout the port does not have. ``buf_words`` is
    the reference's static bound of a TPU shift buffer; it is accepted and
    has no use here."""
    _check_backend(backend, UNPACK_BACKENDS)
    B, Wp = payload.shape
    dev = payload.device
    start = torch.arange(B, dtype=torch.int64, device=dev) * Wp
    count = torch.full((B,), Wp, dtype=torch.int32, device=dev)
    return rice_unpack_words(payload.contiguous().reshape(-1), start, count, k,
                             n, block_len)
