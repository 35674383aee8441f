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
             twins, the plain torch VERTICAL region math and ragged
             copies, and the reference's kernel-level ``pack`` / ``unpack``
  csrc/    — the CUDA C++ sources, built for sm_90a at first use, and the
             C++ host feed (csrc/host/), built with g++ at first use
  native   — the host feed's binding (the stream walk and the block
             build, ``native.stream_addresses``, ``build_streams``)
  dist/    — data parallelism over blocks on a list of devices (the
             sharded frame paths and the four sharded block functions),
             several processes over torch.distributed (gloo), the
             multi-device dry run
  utils/   — resumable encode jobs (``EncodeJob``) and run metrics
  cli/     — encode / decode / verify / bench, ``--sharded``
             (``python -m dctpu_torch.cli.main``)
  bench    — the benchmark of the three coders on the card

The package exports the reference's format constants (``BLOCK_LEN_DEFAULT``,
``DELTA``, ...) and ``dctpu_torch.codec`` its ``compress`` and
``decompress``, as ``dctpu`` and ``dctpu.codec`` do.

All three coders are ported: ``CodecConfig(coder="rice")`` (the default),
``"vertical"`` and ``"adaptive"`` (the CLI default), through
``dctpu_torch.codec.api.compress`` and ``decompress``, with the
reference's encode and decode ``backend`` names and ``chunk_blocks``; so
is the block-batch codec on device tensors, without framing
(``codec.encode.encode_blocks`` -> ``EncodedBlocks``,
``codec.decode.decode_blocks``, their ``*_body`` names and the sharded
forms in ``dist``), the kernel-level ``kernels.pack`` / ``unpack``
(``DCTPU_KERNEL_BACKEND``), and the native host feed. Not ported: the
scalar codec and ``oracle/`` (what the port is checked against), the
compile cache and the TPU timing helpers of ``dctpu/utils`` (JAX only),
and the ``bench/*`` TPU probes.
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
