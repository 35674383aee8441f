"""The ordered device list the sharded paths split blocks over (the
counterpart of ``dctpu/dist/mesh.py``'s 1-D ``streams`` mesh)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The given devices as ``torch.device``s, in order, or by default every
    CUDA device. Raises without a CUDA device when none are given: the
    sharded paths never fall back to the CPU on their own (pass
    ``[torch.device("cpu")] * k`` to run them there)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass the devices")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: empty device list")
    return mesh
