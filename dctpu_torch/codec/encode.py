"""Block encoder: selection (FORMAT §4, §4.1) and per-coder emission.

The counterpart of ``dctpu/codec/encode.py``, split so that each stage can
be timed: the reference's ``encode_blocks`` is :func:`select_blocks` (the
single-coder selection) then :func:`emit_blocks`; its adaptive pair is
:func:`adaptive_select` then :func:`emit_blocks`. :func:`encode_blocks` and
:func:`emit_blocks_body` give the reference's result, :class:`EncodedBlocks`,
from those halves; ``encode_blocks_body`` and ``adaptive_select_body`` are
the reference's names of :func:`encode_blocks` and :func:`adaptive_select`
(there is no jit to separate a body from).

Selection runs the exact totals kernels. Adaptive: K1 for DELTA and
DOUBLE_DELTA and K2's LPC form for each LPC candidate, all read straight
from the samples (the TPU default path ran K2 on each LPC candidate's
zigzag values, derived in XLA). coder="rice": K6's x forms, one launch
for DELTA and DOUBLE_DELTA and one per LPC candidate, also read straight
from the samples (the TPU ran K6 on each candidate's zigzag values,
``rice.choose_k_auto``).
coder="vertical": VC's two forms, the sum of the bit lengths of each
candidate's zigzag residuals, likewise from the samples (XLA on the TPU).
Emission runs the coder of the group:
for VERTICAL, K3's x form, for RICE, K5a's x form; each derives every
block's chosen residuals from the samples and writes the payload rows
(the TPU ran its emit and pack kernels on zigzag values derived in XLA,
then assembled the VERTICAL rows in XLA).

``backend`` is the reference's encode-side kernel choice
(``dctpu/codec/encode.py``, ``dctpu/kernels/api.py``). Every name gives
the same frame; it only picks the implementation of each stage:

  * ``None`` / ``"auto"``, and ``"scan"``, ``"merge"``, ``"scatter"`` (the
    reference's XLA packers; the port's one packer is K5a): as above;
  * ``"pallas"`` (any name starting with it, for VERTICAL): VERTICAL
    emission takes the staged branch on the winner's zigzag values, K9's
    disk-order planes, the width rule, K8, then the region assembly in
    torch;
  * ``"reduce"``: adaptive selection runs K7 for every candidate;
  * ``"bp"``: as ``"auto"`` for selection and VERTICAL emission;
  * ``"xla"``, the reference's portable opt-out: as ``"auto"``, but
    VERTICAL emission takes the staged branch as under ``"pallas"``
    (the reference's staged branch with its XLA extractor). The port has
    one implementation of each stage for a device: the kernels on a CUDA
    device, their plain twins only for CPU tensors, under every name;
  * RICE emission takes only the reference packer's names (``None``,
    ``"auto"``, ``"xla"``, ``"scan"``, ``"merge"``, ``"scatter"``,
    ``"pallas"``) and raises ValueError for any other, as
    ``dctpu/kernels/api.py`` ``pack`` does; no other stage raises.

PyTorch runs eagerly, so there is nothing to compile and no chunking: a
batch of any size runs in one pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from dctpu_torch._bits import to_i32
from dctpu_torch.codec import predict, rice
from dctpu_torch.config import CodecConfig
from dctpu_torch.constants import DELTA, LPC, subs_per_block
from dctpu_torch.kernels.exc_extract import exc_extract
from dctpu_torch.kernels.api import PACK_BACKENDS
from dctpu_torch.kernels.rice_pack import rice_pack_rows
from dctpu_torch.kernels.rice_totals import rice_totals_lpc, rice_totals_xbp
from dctpu_torch.kernels.select_bp import adaptive_totals_lpc, adaptive_totals_xbp
from dctpu_torch.kernels.select_reduce import adaptive_totals_reduce
from dctpu_torch.kernels.transpose import bit_planes32
from dctpu_torch.kernels.vemit import vertical_emit_rows, vertical_emit_rows_z
from dctpu_torch.kernels.vertical import (
    assemble_rows,
    exceed_counts,
    plane_word_counts,
    select_width,
    sub_rows,
)
from dctpu_torch.kernels.vertical_cost import vertical_cost_lpc, vertical_cost_xbp

# the reference RICE packer's backend names (dctpu/kernels/api.py pack)
RICE_PACK_BACKENDS = (None, *PACK_BACKENDS)


class EncodedBlocks(NamedTuple):
    """The reference's encode result, each field int32 on the input's
    device (payload: u32 bit patterns)."""

    predictor: torch.Tensor  # [B]
    k: torch.Tensor          # [B]
    table_idx: torch.Tensor  # [B]
    bit_len: torch.Tensor    # [B]
    payload: torch.Tensor    # [B, W]


def candidate_z(x, history, cfg: CodecConfig, ci: int) -> torch.Tensor:
    """Zigzag residuals [B, L] (int32 bit patterns) of candidate ci."""
    pred, ti = cfg.candidates()[ci]
    coeffs = cfg.lpc_tables[ti].coeffs if pred == LPC else None
    return rice.zigzag(predict.residuals_for_candidate(x, history, pred, coeffs))


def _per_candidate(cfg: CodecConfig, xbp, lpc):
    """Each candidate's result of cfg.candidates(), in order: its row of
    xbp() (DELTA, DOUBLE_DELTA; called once, when first needed) or
    lpc(coeffs) of its table."""
    shift = None
    for pred, ti in cfg.candidates():
        if pred == LPC:
            yield lpc(cfg.lpc_tables[ti].coeffs)
        else:
            if shift is None:
                shift = xbp()
            yield shift[0 if pred == DELTA else 1]


def _first_min(cost: torch.Tensor) -> torch.Tensor:
    """[C, B] -> [B] index of the first minimum over C (the normative
    candidate-order tie-break), as one packed cost * C + c minimum."""
    C = cost.shape[0]
    ax = torch.arange(C, device=cost.device)[:, None]
    return (cost.to(torch.int64) * C + ax).min(0).values % C


def select_blocks(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B] int32
    history: torch.Tensor,  # [B, 4] int32
    cfg: CodecConfig,
    backend: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-coder selection (cfg.coder "rice" or "vertical"), the first
    half of the reference's encode_blocks. Returns (choice, k), each [B]
    int32; k is 0 for VERTICAL.

    RICE: the exact (k, bits) per candidate from K6's x forms, then the
    candidate with the fewest bits. VERTICAL: the candidate with the
    smallest sum of bit lengths, from VC's x forms. Both read only x: one
    DELTA + DOUBLE_DELTA launch and one LPC launch per LPC candidate.
    Every backend name takes this path."""
    L = x.shape[1]
    if cfg.coder == "vertical":
        choice = _first_min(torch.stack(list(_per_candidate(
            cfg,
            lambda: vertical_cost_xbp(x, history, n, L),
            lambda c: vertical_cost_lpc(x, history, n, c, L),
        ))))
        return choice.to(torch.int32), torch.zeros_like(choice, dtype=torch.int32)

    ks, bits = [], []
    for totals in _per_candidate(
        cfg,
        lambda: rice_totals_xbp(x, history, n, L, cfg.k_max),
        lambda c: rice_totals_lpc(x, history, n, c, L, cfg.k_max),
    ):
        k_c, bits_c = rice.best_k(totals)
        ks.append(k_c)
        bits.append(bits_c)
    choice = _first_min(torch.stack(bits))
    k = torch.stack(ks).gather(0, choice[None, :])[0]
    return choice.to(torch.int32), k.to(torch.int32)


def adaptive_select(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B] int32
    history: torch.Tensor,  # [B, 4] int32
    cfg: CodecConfig,
    backend: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FORMAT §4.1 joint (candidate, coder) selection by exact word count.

    Returns (choice, coder 0=RICE/1=VERTICAL, k), each [B] int32. The first
    minimum in the option order c0-RICE, c0-VERT, c1-RICE, ... wins: the
    minimum of the packed key words * (2C) + option.

    The totals come from K1 and K2's LPC form, which derive the
    residuals from x; under backend="reduce", from K7 for every candidate
    on its zigzag residuals (which raises ValueError for k_max > 24, where
    the reference asserts)."""
    L = x.shape[1]
    shift = None
    ks, rws, vws = [], [], []
    for ci, (pred, ti) in enumerate(cfg.candidates()):
        if backend == "reduce":
            totals, vword = adaptive_totals_reduce(
                candidate_z(x, history, cfg, ci), n, L, cfg.k_max
            )
        elif pred == LPC:
            totals, vword = adaptive_totals_lpc(
                x, history, n, cfg.lpc_tables[ti].coeffs, L, cfg.k_max
            )
        else:
            if shift is None:
                shift = adaptive_totals_xbp(x, history, n, L, cfg.k_max)
            gi = 0 if pred == DELTA else 1
            totals, vword = shift[0][gi], shift[1][gi]
        k_c, bits_c = rice.best_k(totals)
        ks.append(k_c)
        rws.append((bits_c + 31) // 32)
        vws.append(vword.to(torch.int64))
    o = _first_min(torch.stack(
        [w for pair in zip(rws, vws) for w in pair]
    ))  # over 2C options: c0-RICE, c0-VERT, c1-RICE, ...
    choice = o >> 1
    coder = o & 1
    k = torch.stack(ks).gather(0, choice[None, :])[0]
    k = torch.where(coder == 0, k, 0)
    return choice.to(torch.int32), coder.to(torch.int32), k.to(torch.int32)


def _emit_staged(z: torch.Tensor, n: torch.Tensor, block_len: int):
    """The staged VERTICAL analysis of the reference's encode_vertical
    (exc_backend "pallas" or "xla"), with K3's outputs: the plane words in
    disk order (K9), the width rule in torch, the exceptions at that width
    (K8)."""
    B = z.shape[0]
    S = subs_per_block(block_len)
    rows = sub_rows(z, n, block_len)  # [B*S, 128] int64, zero past n
    zs = to_i32(rows)
    planes = bit_planes32(zs)  # disk order: plane p of group w at p*4 + w
    pw = plane_word_counts(block_len, z.device).repeat(B)
    b, words, n_exc, e = (
        t.reshape(B, S) for t in select_width(exceed_counts(rows), pw)
    )
    pos_words, vals = exc_extract(zs.reshape(B, S, 128), b.to(torch.int32))
    return planes.reshape(B, S, 128), b, words, n_exc, e, pos_words, vals


def encode_vertical(
    z: torch.Tensor, n: torch.Tensor, block_len: int, exc_backend: str = "mega"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """VERTICAL emission of zigzag values. Returns (payload
    [B, SW + S*REGION_PAD] int32 bit patterns, bit_len [B] int64).

    exc_backend, as in the reference's vertical_xla.encode_vertical:
    "mega" runs K3's z form, which writes the rows; "pallas" and "xla" the
    staged branch with K9 and K8, then the region assembly."""
    if exc_backend == "mega":
        return vertical_emit_rows_z(z, n, block_len)
    planes, b, words, n_exc, e, pos_words, vals = _emit_staged(z, n, block_len)
    payload = assemble_rows(planes, b, n_exc, e, pos_words, vals, block_len)
    return payload, 32 * words.to(torch.int64).sum(1)


def emit_blocks(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B] int32
    history: torch.Tensor,  # [B, 4] int32
    choice: torch.Tensor,   # [B] candidate index
    k: torch.Tensor,        # [B] Rice k (ignored for vertical)
    cfg: CodecConfig,
    coder: str,             # "rice" | "vertical" for this group
    backend: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Emit one coder group with a given (candidate, k) selection.

    Returns (payload rows [B, W] int32 bit patterns, bit_len [B] int64).
    RICE: K5a's x form, one launch, under every packer name. VERTICAL:
    K3's x form, one launch, except under the staged backend names, where
    the winner's zigzag values are derived per candidate over the blocks
    that chose it. A RICE group raises ValueError for a backend name the
    reference's packer does not know."""
    if coder != "vertical" and backend not in RICE_PACK_BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}")
    staged = backend == "xla" or (backend or "").startswith("pallas")
    if coder != "vertical":
        return rice_pack_rows(x, history, n, choice, k, cfg)
    if not staged:
        return vertical_emit_rows(x, history, n, choice, cfg)
    r = predict.chosen_residuals(x, history, choice, predict.candidate_coeffs(cfg))
    return encode_vertical(rice.zigzag(r), n, x.shape[1], "pallas")


@functools.lru_cache(maxsize=16)
def candidate_ids(cfg: CodecConfig, device: torch.device):
    """(predictor [C], table_idx [C]) int32 of ``cfg.candidates()``, the
    table index 0 for DELTA and DOUBLE_DELTA; cached per configuration and
    device, as ``args.candidate_table``."""
    ids = torch.tensor(
        [[p, ti if p == LPC else 0] for p, ti in cfg.candidates()],
        dtype=torch.int32, device=device,
    )
    return ids[:, 0].contiguous(), ids[:, 1].contiguous()


def emit_blocks_body(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B] int32
    history: torch.Tensor,  # [B, 4] int32
    choice: torch.Tensor,   # [B] candidate index
    k: torch.Tensor,        # [B] Rice k (ignored for vertical)
    cfg: CodecConfig,
    coder: str,             # "rice" | "vertical" for this group
    backend: str | None = None,
) -> EncodedBlocks:
    """:func:`emit_blocks` with each block's predictor and table index from
    its candidate, as :class:`EncodedBlocks` (k 0 for VERTICAL)."""
    payload, bit_len = emit_blocks(x, n, history, choice, k, cfg, coder, backend)
    pred, tidx = (t[choice.long()] for t in candidate_ids(cfg, x.device))
    k = (torch.zeros_like(pred) if coder == "vertical"
         else k.to(torch.int32).contiguous())
    return EncodedBlocks(pred, k, tidx, bit_len.to(torch.int32), payload)


def encode_blocks(
    x: torch.Tensor,        # [B, L] int32
    n: torch.Tensor,        # [B] int32 valid lengths
    history: torch.Tensor,  # [B, 4] int32
    cfg: CodecConfig,
    backend: str | None = None,
) -> EncodedBlocks:
    """The reference's encode_blocks: :func:`select_blocks`, then
    :func:`emit_blocks_body` with VERTICAL for coder="vertical" and RICE for
    every other coder, "adaptive" included, as the reference's body does."""
    choice, k = select_blocks(x, n, history, cfg, backend)
    coder = "vertical" if cfg.coder == "vertical" else "rice"
    return emit_blocks_body(x, n, history, choice, k, cfg, coder, backend)


# the reference's names of the same functions
encode_blocks_body = encode_blocks
adaptive_select_body = adaptive_select
