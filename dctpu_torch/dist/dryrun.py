"""The full sharded encode and decode over n devices, checked against one
device: the counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``.

  python -m dctpu_torch.dist.dryrun    # over every CUDA device
"""

from __future__ import annotations

import numpy as np

from dctpu_torch.codec.api import compress
from dctpu_torch.config import CodecConfig
from dctpu_torch.dist.mesh import make_mesh
from dctpu_torch.dist.sharded import compress_sharded, decompress_sharded
from dctpu_torch.format.frame import write_frame


def dryrun_multichip(n_devices: int, mesh=None) -> None:
    """The sharded pipeline over the first n_devices of ``mesh`` (default
    :func:`make_mesh`) at the production geometry: the adaptive coder at
    block_len 4096 on a three-stream corpus that gives a mixed frame,
    4 * n_devices blocks in chunks of 2 * n_devices (two chunks), the
    sharded frame byte-identical to the single-device one, and a bit-exact
    round trip. Raises AssertionError where a check fails."""
    devs = make_mesh(mesh)[:n_devices]
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")

    cfg = CodecConfig(coder="adaptive")  # production default: L=4096, §4.1
    L = cfg.block_len
    B = 4 * n_devices
    rng = np.random.default_rng(7)
    third = B * L // 3
    streams = [
        # smooth load profile -> RICE-friendly blocks
        (500 + 50 * np.sin(np.arange(third) / 40) + rng.normal(0, 3, third))
        .astype(np.int32),
        # near-constant register -> VERTICAL-friendly blocks
        (np.arange(third) // 97).astype(np.int32),
        # full-range noise -> escape-heavy blocks
        rng.integers(-(2**28), 2**28, size=third, dtype=np.int64).astype(np.int32),
    ]
    chunk = 2 * n_devices

    frame = compress_sharded(streams, cfg, mesh=devs, chunk_blocks=chunk)
    coders = frame.blocks.coder_arr()
    if not (coders.min() == 0 and coders.max() == 1):
        raise AssertionError(
            f"adaptive dryrun expected a mixed frame, got coders={set(coders.tolist())}"
        )
    single = compress(streams, cfg, device=devs[0], chunk_blocks=chunk)
    if write_frame(frame) != write_frame(single):
        raise AssertionError("sharded frame != single-device frame")

    out = decompress_sharded(frame, mesh=devs, chunk_blocks=chunk)
    for a, b in zip(streams, out):
        if not np.array_equal(a, b):
            raise AssertionError("multichip round trip not bit-exact")


if __name__ == "__main__":
    mesh = make_mesh()
    dryrun_multichip(len(mesh), mesh)
    print(f"dryrun_multichip OK over {len(mesh)} devices")
