"""dctpu_torch — the dctpu codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``dctpu`` (JAX on a TPU), which stays beside it as the
reference: the same DCF1 frames (docs/FORMAT.md), byte for byte. This
package imports torch and numpy and never jax or ``dctpu``.

Layers, mirroring ``dctpu``:
  format/  — DCF1 frame and DCR1 raw serializers (host numpy copies)
  corpus/  — synthetic load-profile generator (copy)
  codec/   — predictors, Rice math, block encode/decode, host API, and
             corpus-fit LPC tables (``select``, copy)
  kernels/ — CUDA kernels K1-K9 (csrc/) with plain torch twins, and the
             plain torch VERTICAL region math and ragged copies
  csrc/    — the CUDA C++ sources, built for sm_90a at first use
  cli/     — encode / decode / verify (``python -m dctpu_torch.cli.main``)

All three coders are ported: ``CodecConfig(coder="rice")`` (the default),
``"vertical"`` and ``"adaptive"`` (the CLI default), through
``dctpu_torch.codec.api.compress`` and ``decompress``, with the
reference's encode ``backend`` names. Not yet ported: the sharded and
multi-process paths, the CLI's ``--sharded`` flag and ``bench`` verb, and
the reference's decode backends. The compile cache of ``dctpu/utils`` is
JAX-only and has no counterpart.
"""

from dctpu_torch.config import CodecConfig, DEFAULT_LPC_TABLES, LpcTable  # noqa: F401

__version__ = "0.1.0"
