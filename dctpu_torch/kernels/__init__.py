"""Hand-written CUDA kernels (``dctpu_torch/csrc``) behind torch wrappers,
and the plain-torch stages around them.

  select_bp    K1, K2  exact adaptive-selection totals
  vemit        K3      VERTICAL emission into the payload rows
  vdec         K4      VERTICAL decode (of a frame's words, or of payload rows)
  rice_pack    K5a     RICE payload rows (from the raw samples, z, or codewords)
  rice_unpack  K5b     RICE bit unpacker
  rice_totals  K6      exact RICE totals per k (coder="rice" selection)
  select_reduce K7     K2's totals on K2's code (backend="reduce")
  exc_extract  K8      VERTICAL exceptions at given widths (backend="pallas")
  transpose    K9      bit planes of 32-word groups, disk order (backend="pallas")
  reconstruct  R       unzigzag + predictor inverse (decode)
  vertical_cost VC     VERTICAL selection cost (coder="vertical" selection)
  compact      CP      the encode's compaction: payload rows -> compact words
  vertical, ragged: plain torch (XLA code on the TPU)
  args: the kernel arguments several wrappers share
  api: the reference's kernel-level RICE API, exported here as in
       ``dctpu.kernels``: ``pack`` and ``unpack`` (K5a's codes form and
       K5b on a card), their plain twins ``pack_xla`` and ``unpack_xla``,
       and ``padded_words``
"""

from dctpu_torch.kernels.api import pack, pack_xla, unpack, unpack_xla  # noqa: F401
from dctpu_torch.kernels.rice_pack import padded_words  # noqa: F401
