"""Distribution layer: the device list, data parallelism over blocks, and
several processes (the counterpart of ``dctpu/dist``).

A codec has one parallel axis, the independent blocks of independent
streams (the reference's 1-D ``streams`` mesh):

  mesh      ``make_mesh``: the ordered list of devices
  sharded   ``compress_sharded`` / ``decompress_sharded``: each chunk of
            blocks cut into one contiguous shard per device, gathered in
            block order (the same frame as ``compress``)
  multihost ``initialize`` / ``compress_multihost``: one process per
            device over ``torch.distributed`` (gloo), process 0 assembles
  dryrun    ``dryrun_multichip``: the sharded round trip against one
            device

The reference's jitted ``encode_blocks_sharded`` and
``decode_blocks_sharded`` have no counterpart of their own: their work is
``codec/api.py``'s range encoder and decoder, run once per shard.
"""

from dctpu_torch.dist.dryrun import dryrun_multichip  # noqa: F401
from dctpu_torch.dist.mesh import make_mesh  # noqa: F401
from dctpu_torch.dist.sharded import compress_sharded, decompress_sharded  # noqa: F401
