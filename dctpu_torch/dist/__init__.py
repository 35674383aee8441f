"""Distribution layer: the device list, data parallelism over blocks, and
several processes (the counterpart of ``dctpu/dist``).

A codec has one parallel axis, the independent blocks of independent
streams (the reference's 1-D ``streams`` mesh):

  mesh      ``make_mesh``: the ordered list of devices
  sharded   ``compress_sharded`` / ``decompress_sharded``: each chunk of
            blocks cut into one contiguous shard per device, gathered in
            block order (the same frame as ``compress``); and the block
            functions ``encode_blocks_sharded``, ``decode_blocks_sharded``,
            ``adaptive_select_sharded`` and ``emit_blocks_sharded``: the
            block-batch codec of ``codec/encode.py`` and ``decode.py`` on
            one contiguous shard per device, gathered on the first
  multihost ``initialize`` / ``compress_multihost``: one process per
            device over ``torch.distributed`` (gloo), process 0 assembles
  dryrun    ``dryrun_multichip``: the sharded round trip against one
            device

As in ``dctpu.dist``, the package exports ``encode_blocks_sharded`` and
``decode_blocks_sharded``; the other two block functions are names of
``dist.sharded``.
"""

from dctpu_torch.dist.dryrun import dryrun_multichip  # noqa: F401
from dctpu_torch.dist.mesh import make_mesh  # noqa: F401
from dctpu_torch.dist.sharded import (  # noqa: F401
    compress_sharded,
    decode_blocks_sharded,
    decompress_sharded,
    encode_blocks_sharded,
)
