"""dctpu_torch — the dctpu codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``dctpu`` (JAX on a TPU), which stays beside it as the
reference: the same DCF1 frames (docs/FORMAT.md), byte for byte. This
package imports torch and numpy and never jax or ``dctpu``.

Layers, mirroring ``dctpu``:
  format/  — DCF1 frame and DCR1 raw serializers (host numpy copies)
  corpus/  — synthetic load-profile generator (copy)
  codec/   — predictors, Rice math, block encode/decode, host API, and
             corpus-fit LPC tables (``select``, copy)
  kernels/ — CUDA kernels K1-K9, R, VC and CP (csrc/) with plain torch
             twins, and the plain torch VERTICAL region math and ragged
             copies
  csrc/    — the CUDA C++ sources, built for sm_90a at first use
  dist/    — data parallelism over blocks on a list of devices, several
             processes over torch.distributed (gloo), the multi-device dry run
  utils/   — resumable encode jobs (``EncodeJob``) and run metrics
  cli/     — encode / decode / verify, ``--sharded``
             (``python -m dctpu_torch.cli.main``)

The package exports the reference's format constants (``BLOCK_LEN_DEFAULT``,
``DELTA``, ...) and ``dctpu_torch.codec`` its ``compress`` and
``decompress``, as ``dctpu`` and ``dctpu.codec`` do.

All three coders are ported: ``CodecConfig(coder="rice")`` (the default),
``"vertical"`` and ``"adaptive"`` (the CLI default), through
``dctpu_torch.codec.api.compress`` and ``decompress``, with the
reference's encode and decode ``backend`` names and ``chunk_blocks``.
Not yet ported: the CLI's ``bench`` verb, which waits for the port's
benchmark. The compile cache and the TPU timing helpers of
``dctpu/utils`` are JAX-only and have no counterpart.
"""

from dctpu_torch.constants import (  # noqa: F401
    BLOCK_LEN_DEFAULT,
    DELTA,
    DOUBLE_DELTA,
    ESCAPE_Q,
    K_MAX,
    LPC,
    MAX_CODE_BITS,
    RAW_BITS,
)
from dctpu_torch.config import CodecConfig, DEFAULT_LPC_TABLES, LpcTable  # noqa: F401

__version__ = "0.1.0"
