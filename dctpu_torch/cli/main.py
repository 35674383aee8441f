"""dcomp on PyTorch: encode / decode / verify / bench (the port of
dctpu/cli/main.py).

Reads DCR1 raw corpus containers (or bare little-endian int32 files) and
writes DCF1 frames, byte-identical to the reference CLI's. Runs on the
CUDA card unless ``--device cpu`` is given.

  python -m dctpu_torch.cli.main encode in.dcr out.dcf [--block-len N]
      [--predictors delta,dd,lpc] [--coder rice|vertical|adaptive]
      [--fit-tables] [--device cuda|cpu] [--sharded]
  python -m dctpu_torch.cli.main decode in.dcf out.dcr [--device ...] [--sharded]
  python -m dctpu_torch.cli.main verify in.dcr [same flags as encode]
  python -m dctpu_torch.cli.main bench [--streams N] [--samples N]
      [--block-len N] [--repeats N] [--device cuda|cpu] [--out PATH]

--sharded splits the blocks over every CUDA device (with --device cuda) or
over the one device --device names. bench runs dctpu_torch.bench (its
docstring has the keys) and returns its exit code.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from dctpu_torch import bench
from dctpu_torch.codec.api import compress, decompress
from dctpu_torch.codec.select import fit_lpc_tables
from dctpu_torch.config import CodecConfig
from dctpu_torch.constants import DELTA, DOUBLE_DELTA, LPC, RAW_MAGIC
from dctpu_torch.dist import compress_sharded, decompress_sharded, make_mesh
from dctpu_torch.format import read_frame, read_raw, write_frame, write_raw


def _load_streams(path: str):
    data = Path(path).read_bytes()
    if data[:4] == RAW_MAGIC:
        return read_raw(data)
    # bare int32 file = single stream
    return [np.frombuffer(data, dtype="<i4").copy()], [0], [900]


def _cfg(args, streams) -> CodecConfig:
    names = {"delta": DELTA, "dd": DOUBLE_DELTA, "lpc": LPC}
    preds = tuple(names[p] for p in args.predictors.split(","))
    kw = {"lpc_tables": fit_lpc_tables(streams)} if args.fit_tables else {}
    return CodecConfig(
        block_len=args.block_len, predictors=preds, coder=args.coder, **kw
    )


def _mesh(args):
    """--sharded's devices: every CUDA device for --device cuda, else the
    one device named."""
    return make_mesh() if args.device == "cuda" else make_mesh([args.device])


def _compress(args, streams, ids, cads):
    cfg = _cfg(args, streams)
    if args.sharded:
        return compress_sharded(streams, cfg, _mesh(args), ids, cads)
    return compress(streams, cfg, ids, cads, device=args.device)


def _decompress(args, frame):
    if args.sharded:
        return decompress_sharded(frame, _mesh(args))
    return decompress(frame, device=args.device)


def cmd_encode(args):
    streams, ids, cads = _load_streams(args.input)
    raw = sum(s.nbytes for s in streams)
    t0 = time.time()
    data = write_frame(_compress(args, streams, ids, cads))
    dt = time.time() - t0
    Path(args.output).write_bytes(data)
    print(
        f"encoded {len(streams)} streams: {raw} -> {len(data)} bytes "
        f"({raw/len(data):.3f}x) in {dt:.2f}s ({raw/dt/1e9:.3f} GB/s)",
        file=sys.stderr,
    )


def cmd_decode(args):
    frame = read_frame(Path(args.input).read_bytes())
    t0 = time.time()
    streams = _decompress(args, frame)
    dt = time.time() - t0
    ids = [s.stream_id for s in frame.streams]
    cads = [s.cadence_s for s in frame.streams]
    Path(args.output).write_bytes(write_raw(streams, ids, cads))
    raw = sum(s.nbytes for s in streams)
    print(f"decoded {raw} bytes in {dt:.2f}s ({raw/dt/1e9:.3f} GB/s)", file=sys.stderr)


def cmd_verify(args):
    streams, ids, cads = _load_streams(args.input)
    data = write_frame(_compress(args, streams, ids, cads))
    out = _decompress(args, read_frame(data))
    ok = len(out) == len(streams) and all(
        np.array_equal(a, b) for a, b in zip(streams, out)
    )
    raw = sum(s.nbytes for s in streams)
    print(f"verify: {'OK' if ok else 'MISMATCH'}  ratio={raw/len(data):.3f}x",
          file=sys.stderr)
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(prog="dcomp", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs "
                             "the kernels' plain torch twins)")
        sp.add_argument("--sharded", action="store_true",
                        help="shard the blocks over all local CUDA devices "
                             "(over the --device given, if not cuda)")

    def common(sp):
        sp.add_argument("input")
        sp.add_argument("--block-len", type=int, default=4096)
        sp.add_argument("--predictors", default="delta,dd,lpc")
        sp.add_argument("--coder", default="adaptive",
                        choices=["rice", "vertical", "adaptive"],
                        help="rice = classic Rice frames, vertical = bit-plane "
                             "coder, adaptive = per-block best of both "
                             "(FORMAT §4.1, default)")
        sp.add_argument("--fit-tables", action="store_true",
                        help="replace the built-in LPC tables with "
                             "corpus-fit OLS->Q16 tables (serialized into "
                             "the frame; decoders need no side channel)")
        device(sp)

    sp = sub.add_parser("encode", help="DCR1/raw int32 -> DCF1")
    common(sp)
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help="DCF1 -> DCR1")
    sp.add_argument("input")
    sp.add_argument("output")
    device(sp)
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("verify", help="round-trip self check")
    common(sp)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("bench", help="time the three coders' round trips")
    bench.add_arguments(sp)
    sp.set_defaults(fn=bench.run)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
