"""VC: the coder="vertical" selection cost per block and candidate.

The counterpart of ``dctpu/kernels/vertical_xla.py``
``vertical_selection_cost`` over ``dctpu/codec/encode.py`` ``_cand_z_fn``,
which the reference runs in XLA (no Pallas kernel): FORMAT §2.2's proxy,
the sum of the bit lengths of a candidate's valid zigzag residuals. The
CUDA kernel (``dctpu_torch/csrc/select.cu`` ``vertical_cost_kernel``)
derives the residuals from the raw samples, in two forms, as K6's x forms:

  * :func:`vertical_cost_xbp` (``dct_vertical_cost_xbp``): DELTA and
    DOUBLE_DELTA in one read of x;
  * :func:`vertical_cost_lpc` (``dct_vertical_cost_lpc``): one LPC
    candidate.

``encode.select_blocks`` runs both for coder="vertical". The twins are
``vertical.vertical_selection_cost`` on torch's residuals (bound here by
name, so that a stage patched on ``vertical`` does not reach them).

Each wrapper runs its plain torch twin for tensors on the CPU and launches
its kernel for tensors on a CUDA device; its ``launches`` attribute counts
the kernel launches. Neither takes k_max: the VERTICAL coder has none.
"""

from __future__ import annotations

import torch

from dctpu_torch.codec import rice
from dctpu_torch.codec.predict import residuals_for_candidate
from dctpu_torch.constants import DELTA, DOUBLE_DELTA, LPC
from dctpu_torch.kernels import _build
from dctpu_torch.kernels.args import check_x, lpc_coeffs
from dctpu_torch.kernels.vertical import vertical_selection_cost


def _check_block_len(block_len: int) -> None:
    # a block's cost is at most 32 * block_len, summed in int32
    if 32 * block_len >= 2**31:
        raise ValueError(f"block_len {block_len} too large for an int32 cost")


def _candidate_plain(x, history, n, pred, coeffs, block_len):
    valid = (torch.arange(block_len, device=x.device)[None, :]
             < n.to(torch.int64)[:, None])
    z = rice.zigzag(residuals_for_candidate(x, history, pred, coeffs))
    return vertical_selection_cost(z, valid).to(torch.int32)


def vertical_cost_xbp_plain(x, history, n, block_len: int) -> torch.Tensor:
    """Plain twin of VC's DELTA + DOUBLE_DELTA form: [2, B] int32."""
    return torch.stack([
        _candidate_plain(x, history, n, pred, None, block_len)
        for pred in (DELTA, DOUBLE_DELTA)
    ])


def vertical_cost_xbp(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    block_len: int,
) -> torch.Tensor:
    """VC, DELTA + DOUBLE_DELTA form: the sums of the bit lengths of the
    valid zigzag residuals [2, B] int32 from one read of x, candidate axis
    order (DELTA, DOUBLE_DELTA)."""
    _check_block_len(block_len)
    if x.device.type == "cpu":
        return vertical_cost_xbp_plain(x, history, n, block_len)
    if x.device.type != "cuda":
        raise ValueError(f"vertical_cost_xbp: unsupported device {x.device}")
    n = check_x("vertical_cost_xbp", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty((B, 2), dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_vertical_cost_xbp", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(), B, L,
        )
        vertical_cost_xbp.launches += 1
    return out.t()


vertical_cost_xbp.launches = 0


def vertical_cost_lpc_plain(x, history, n, coeffs, block_len: int) -> torch.Tensor:
    """Plain twin of VC's LPC form: [B] int32."""
    return _candidate_plain(x, history, n, LPC, coeffs, block_len)


def vertical_cost_lpc(
    x: torch.Tensor,        # [B, L] int32 raw samples (garbage past n)
    history: torch.Tensor,  # [B, 4] int32 pre-block history
    n: torch.Tensor,        # [B] valid counts
    coeffs,                 # four int32 Q16 coefficients of one LPC table
    block_len: int,
) -> torch.Tensor:
    """VC, LPC form: the sums of the bit lengths of one LPC candidate's
    valid zigzag residuals [B] int32, the residuals derived from x in the
    kernel (wrapping int64 accumulator, arithmetic >> 16, as
    ``predict.residuals_for_candidate``). Raises ValueError for a
    coefficient outside int32, the frame's type."""
    _check_block_len(block_len)
    coeffs = lpc_coeffs(coeffs)
    if x.device.type == "cpu":
        return vertical_cost_lpc_plain(x, history, n, coeffs, block_len)
    if x.device.type != "cuda":
        raise ValueError(f"vertical_cost_lpc: unsupported device {x.device}")
    n = check_x("vertical_cost_lpc", x, history, n, block_len)
    B, L = x.shape
    out = torch.empty(B, dtype=torch.int32, device=x.device)
    if B:
        _build.launch(
            "dct_vertical_cost_lpc", x,
            x.data_ptr(), history.data_ptr(), n.data_ptr(), out.data_ptr(),
            B, L, *coeffs,
        )
        vertical_cost_lpc.launches += 1
    return out


vertical_cost_lpc.launches = 0
