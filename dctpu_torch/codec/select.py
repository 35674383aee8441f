"""Corpus-fit shared LPC coefficient tables (SURVEY.md §2.1 "Shared code
tables"): fit fixed-point predictors to a sample of the corpus, to replace or
extend the built-in DEFAULT_LPC_TABLES. The fitted tables are serialized into
the frame, so decoders need no side channel.

Fit: ordinary least squares on lagged samples (normal equations over the
pooled corpus sample), then quantization to Q16 int32. Stability is not a
concern for compression (any coefficients are losslessly invertible); only
prediction quality matters.

A copy of the module of the same path in ``dctpu``: the port never imports
``dctpu``, whose package import pulls in jax.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dctpu_torch.config import LpcTable
from dctpu_torch.constants import LPC_MAX_ORDER, LPC_SHIFT


def fit_lpc_table(
    streams: Sequence[np.ndarray],
    order: int,
    max_samples_per_stream: int = 1 << 16,
) -> LpcTable:
    """Least-squares order-`order` predictor over the pooled streams."""
    if not (1 <= order <= LPC_MAX_ORDER):
        raise ValueError(f"order must be 1..{LPC_MAX_ORDER}")
    AtA = np.zeros((order, order), dtype=np.float64)
    Atb = np.zeros(order, dtype=np.float64)
    for s in streams:
        x = np.asarray(s, dtype=np.float64)[:max_samples_per_stream]
        if x.size <= order:
            continue
        # rows: [x_{t-1} ... x_{t-order}] -> target x_t
        cols = [x[order - 1 - j : x.size - 1 - j] for j in range(order)]
        A = np.stack(cols, axis=1)
        b = x[order:]
        AtA += A.T @ A
        Atb += A.T @ b
    try:
        c = np.linalg.solve(AtA + 1e-9 * np.eye(order), Atb)
    except np.linalg.LinAlgError:
        c = np.zeros(order)
        c[0] = 1.0
    q = np.clip(np.round(c * (1 << LPC_SHIFT)), -(2**31), 2**31 - 1).astype(
        np.int64
    )
    coeffs = [int(v) for v in q] + [0] * (LPC_MAX_ORDER - order)
    return LpcTable(order=order, coeffs=tuple(coeffs))


def fit_lpc_tables(
    streams: Sequence[np.ndarray],
    orders: Tuple[int, ...] = (1, 2, 3, 4),
    sample_streams: int = 64,
) -> Tuple[LpcTable, ...]:
    """One fitted table per requested order, from a corpus sample."""
    sample = list(streams[:sample_streams])
    return tuple(fit_lpc_table(sample, o) for o in orders)
