"""The system under test, ``dctpu_torch``, as the loop calls it.

The only module of the benchmark that imports the program. A test hands
the loop another object with the same five functions.
"""

from __future__ import annotations

import types


def settings(cfg: dict):
    """The program's ``CodecConfig`` of a configuration file."""
    from dctpu_torch.config import CodecConfig, LpcTable

    return CodecConfig(
        block_len=cfg["block_len"],
        predictors=tuple(cfg["predictors"]),
        lpc_tables=tuple(LpcTable(order=o, coeffs=tuple(c)) for o, c in cfg["lpc_tables"]),
        k_max=cfg["k_max"],
        coder=cfg["coder"],
    )


def load() -> types.SimpleNamespace:
    """The program's entry points, with its kernels and its native host
    feed built or loaded (under ``build/dctpu_torch/`` in the checkout)."""
    from dctpu_torch import native
    from dctpu_torch.kernels import _build

    _build.library()
    native.library()
    return entry_points()


def entry_points() -> types.SimpleNamespace:
    """The program's entry points, nothing built (its CPU path)."""
    from dctpu_torch.codec import api
    from dctpu_torch.format.frame import read_frame, write_frame

    return types.SimpleNamespace(
        compress=api.compress, decompress=api.decompress,
        decompress_flat=api.decompress_flat, write_frame=write_frame,
        read_frame=read_frame, settings=settings,
    )
