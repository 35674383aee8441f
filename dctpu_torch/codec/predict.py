"""Predictor stage over [num_blocks, block_len] tensors (FORMAT §3).

The counterpart of ``dctpu/codec/predict.py``. All sample arithmetic wraps
in int32: it is done in int64 and wrapped once (``_bits.to_i32``), which is
the same arithmetic mod 2**32. The LPC accumulator is wrapping int64 with
an arithmetic ``>> 16``, as the format prescribes.

  - forward residuals: whole-tensor shifts and subtractions;
  - DELTA / DOUBLE_DELTA reconstruction: prefix sums;
  - LPC reconstruction: a true recurrence (the Q16 floor shift is not
    associative), run here as a Python loop over the samples, vectorized over
    the blocks.

The reconstruction functions are the plain twin of kernel R
(``kernels/reconstruct.py``), which runs the decode on a card.
"""

from __future__ import annotations

import torch

from dctpu_torch._bits import MASK32, to_i32
from dctpu_torch.constants import DELTA, DOUBLE_DELTA, LPC, LPC_SHIFT


def _shift_right_one(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, L] with column t holding input column t-1; col 0 = fill."""
    return torch.cat([fill[:, None], x[:, :-1]], dim=1)


def _lpc_prediction(x64, lagged, coeffs) -> torch.Tensor:
    """The Q16 prediction from the lagged samples, int64 (wrapping
    accumulator, arithmetic >> 16)."""
    acc = torch.zeros_like(x64)
    for j, c in enumerate(coeffs):
        if int(c) != 0:
            acc = acc + int(c) * lagged[j]  # wrapping int64
    return acc >> LPC_SHIFT


def _lagged(x64, h, lags: int):
    """[x_{t-1}, ..., x_{t-lags}], each [B, L] int64."""
    out = [_shift_right_one(x64, h[:, 0])]
    for j in range(1, lags):
        out.append(_shift_right_one(out[-1], h[:, j]))
    return out


def lpc_predict_encode(x: torch.Tensor, history: torch.Tensor, coeffs) -> torch.Tensor:
    """LPC prediction [B, L] int32 from the true samples (encode side)."""
    x64 = x.to(torch.int64)
    lagged = _lagged(x64, history.to(torch.int64), 4)
    return to_i32(_lpc_prediction(x64, lagged, coeffs))


def residuals_for_candidate(
    x: torch.Tensor, history: torch.Tensor, predictor: int, coeffs
) -> torch.Tensor:
    """Forward residuals [B, L] int32 for one (predictor, table) candidate."""
    x64 = x.to(torch.int64)
    h = history.to(torch.int64)
    if predictor == DELTA:
        return to_i32(x64 - _lagged(x64, h, 1)[0])
    if predictor == DOUBLE_DELTA:
        x1, x2 = _lagged(x64, h, 2)
        return to_i32(x64 - x1 - x1 + x2)
    if predictor == LPC:
        return to_i32(x64 - _lpc_prediction(x64, _lagged(x64, h, 4), coeffs))
    raise ValueError(f"unknown predictor {predictor}")


def all_candidate_residuals(x: torch.Tensor, history: torch.Tensor, cfg) -> torch.Tensor:
    """[C, B, L] int32 residuals of every candidate of cfg, in the
    normative order."""
    return torch.stack([
        residuals_for_candidate(x, history, pred, coeffs)
        for pred, coeffs in candidate_coeffs(cfg)
    ])


def candidate_coeffs(cfg) -> list:
    """[(predictor, four Q16 coefficients)] of ``cfg.candidates()`` in
    order; (0, 0, 0, 0) for DELTA and DOUBLE_DELTA."""
    return [
        (p, tuple(cfg.lpc_tables[ti].coeffs) if p == LPC else (0, 0, 0, 0))
        for p, ti in cfg.candidates()
    ]


def chosen_residuals(
    x: torch.Tensor, history: torch.Tensor, choice: torch.Tensor, candidates
) -> torch.Tensor:
    """Residuals [B, L] int32 of each block's chosen candidate: block i
    takes ``candidates[choice[i]]``, a (predictor, coeffs) pair. Each
    candidate is derived over the blocks that chose it."""
    r = torch.zeros_like(x, dtype=torch.int32)
    for ci, (pred, coeffs) in enumerate(candidates):
        rows = torch.nonzero(choice == ci).squeeze(1)
        if rows.numel():
            r[rows] = residuals_for_candidate(x[rows], history[rows], pred, coeffs)
    return r


# ------------------------------------------------------------------ decode


def reconstruct_delta(r: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    return to_i32(torch.cumsum(r.to(torch.int64), dim=1) + history[:, 0:1])


def reconstruct_double_delta(
    r: torch.Tensor, history: torch.Tensor
) -> torch.Tensor:
    h = history.to(torch.int64)
    d = torch.cumsum(r.to(torch.int64), dim=1) + (h[:, 0:1] - h[:, 1:2])
    return to_i32(torch.cumsum(d, dim=1) + h[:, 0:1])


def reconstruct_lpc(
    r: torch.Tensor, history: torch.Tensor, coeffs_per_block: torch.Tensor
) -> torch.Tensor:
    """LPC recurrence, vectorized over blocks, sequential over samples.

    r: [B, L] int32; history: [B, 4] int32; coeffs_per_block: [B, 4] int64.
    x_t = wrap32(r_t + (wrap64(sum_j c_j x_{t-1-j}) >> 16)).
    """
    B, L = r.shape
    c = coeffs_per_block.to(torch.int64)
    h = [history[:, j].to(torch.int64) for j in range(4)]
    # r_t + 2**31, so that ((. + p) & MASK32) - 2**31 is the wrapped sample
    r_off = r.to(torch.int64) + 0x80000000
    out = torch.empty((B, L), dtype=torch.int64, device=r.device)
    for t in range(L):
        acc = c[:, 0] * h[0] + c[:, 1] * h[1] + c[:, 2] * h[2] + c[:, 3] * h[3]
        x_t = ((r_off[:, t] + (acc >> LPC_SHIFT)) & MASK32) - 0x80000000
        out[:, t] = x_t
        h = [x_t, h[0], h[1], h[2]]
    return out.to(torch.int32)


def reconstruct_all(
    r: torch.Tensor,
    history: torch.Tensor,
    predictor: torch.Tensor,
    table_coeffs: torch.Tensor,
    table_idx: torch.Tensor,
) -> torch.Tensor:
    """Per-block predictor dispatch (decode). table_coeffs: [T, 4] int64.

    The LPC recurrence runs only over the blocks whose predictor is LPC."""
    x = torch.where(
        (predictor == DELTA)[:, None],
        reconstruct_delta(r, history),
        reconstruct_double_delta(r, history),
    )
    rows = torch.nonzero(predictor == LPC).squeeze(1)
    if rows.numel():
        coeffs = table_coeffs[table_idx[rows].to(torch.int64)]
        x[rows] = reconstruct_lpc(r[rows], history[rows], coeffs)
    return x
