"""The control of the comparison that decides ``correct``: a stand-in for
the program that has to come out as not correct.

The configurations state no precision; they state two guarantees, a
lossless round trip and a canonical frame. The control breaks the first
in the way a lossy codec would: it is the plain reference put in the
program's place, encoding every sample with its lowest bit cleared (a
2 W or 2 Wh step), and its decode returns those samples. Its frames are
well formed and decode to what it encoded, so only the comparison with the
reference and with the inputs can catch it.

  python -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs the cell's harness with the control in the program's place, once per
seed in one process, at the cell's own sizes, and prints each run's
compared numbers. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import check
from portbench.reference import codec, frame


class Control:
    """The program's five entry points, as the lossy stand-in."""

    def __init__(self):
        self.frames = {}

    @staticmethod
    def settings(cfg: dict):
        return check.settings(cfg)

    def compress(self, streams, cfg, stream_ids, cadences, device="cuda", stage_ms=None):
        lens = np.array([s.size for s in streams], np.int64)
        x = torch.from_numpy(np.concatenate(streams)).to(device) & ~1
        blocks = codec.encode(x, lens, cfg)
        data = frame.frame_bytes(blocks, cfg.block_len, stream_ids, cadences, lens,
                                 cfg.lpc_tables)
        self.frames = {id(data): (x.cpu().numpy(), lens)}
        return data

    @staticmethod
    def write_frame(data):
        return data

    def read_frame(self, data):
        return self.frames[id(data)]

    @staticmethod
    def decompress_flat(handle, device="cuda", stage_ms=None):
        return handle

    @staticmethod
    def decompress(handle, device="cuda", stage_ms=None):
        flat, lens = handle
        return np.split(flat, np.cumsum(lens)[:-1])


def main(argv=None) -> int:
    from portbench import registry, run

    p = argparse.ArgumentParser(description="the control, on the chip")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    for seed in a.seeds:
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
        result, values = run.execute(args, Control(), torch.device("cuda", 0), bench)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
