#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dctpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

  1. prints the card (nvidia-smi name and power limit) and builds the CUDA
     kernels from dctpu_torch/csrc (one nvcc per source, in parallel), with
     each kernel's ptxas registers and R's SASS (cuobjdump), whose walk it
     traces from x_(t-1) to x_t;
  2. holds each kernel K1-K9 and R against its plain torch twin on the
     card, bit-exact, at 256 x 4096, 8192 x 4096, 256 x 200
     (block_len % 128 != 0) and 32 x 12000 (rows too large for K5a's
     shared-memory path), with edge rows, and times both at 8192 x 4096
     with CUDA events beside each kernel's bound; K2 in both its forms,
     on zigzag values and on the raw samples with an LPC table ("K2-lpc":
     each default table and one whose products wrap the int64
     accumulator), K6 in its three: on zigzag values, on the raw samples
     for DELTA + DOUBLE_DELTA ("K6-xbp") and for an LPC table ("K6-lpc",
     the same tables), VC, the coder="vertical" selection cost, in its
     two, both on the raw samples ("VC-xbp" for DELTA + DOUBLE_DELTA,
     "VC-lpc" for an LPC table, the same tables), K3 in its two, the
     payload rows from the raw
     samples with every candidate of those tables chosen ("K3") and from
     zigzag values ("K3-z"), K5a in its two, likewise ("K5a", the RICE
     rows from the raw samples at every k in 0..30, and "K5a-z"), K9's
     disk-order planes, R (the reconstruction) in its range form (each
     block's row read from one of two shuffled coder groups) on every
     predictor and table, with histories at the int32 extremes, timed also
     with every block on one predictor at 8192 and 512 blocks beside
     torch.cumsum as DELTA's yardstick, and the decode kernels
     K4 and K5b on the compact words of their blocks, laid out in a
     shuffled order between words of no block, a few RICE blocks cut
     short, and a bad VERTICAL sync entry that must raise;
  3. drives compress -> write_frame -> read_frame -> decompress for the
     adaptive, rice and vertical coders at the bench geometry (8192 blocks
     x 4096 int32 = 128 MiB, resident on the card), each with the launch
     counters set to 0 just before it and read just after: every round
     trip bit-exact, every kernel of each path launched (K6-xbp once,
     K6-lpc once per LPC candidate and K6's z form never on the rice path;
     VC-xbp once and VC-lpc once per LPC candidate on the vertical paths,
     never on the others;
     K1 once and K2's LPC form once per LPC candidate on the adaptive
     paths; R once per decode range (here one) in every decode, K5b once
     per RICE group and K4 once per VERTICAL group; K3 once per VERTICAL
     group and its z form never; K5a's x form once per RICE group and its
     z form never), and the plain torch stages that R, K3, K4, K5a, K5b and VC
     replace never run (the LPC recurrence loop, the region assembly, the
     winner's residuals in an emission, the staging of the decode's
     rows, the VERTICAL selection cost), with the device segments each compress obtained from
     the allocator and the peak device bytes per input byte of each
     compress and decompress (and, for the adaptive path, the stage times
     of a second compress on the cached segments); that the default pass
     keeps the corpus in one range on this card; then, on the same corpus,
     the adaptive selection under
     backend="reduce" (K7 once per candidate on the torch residuals, K1
     and K2 never; equal to the default selection, which is the
     full-size check of the LPC residuals derived in K2), the VERTICAL
     emission of the vertical path's selection through K3's z form (the
     reference's encode_vertical signature; rows equal to the x form's),
     the RICE emission of the rice path's selection through K5a's z form
     (the reference's pack signature; rows equal to the x form's), and
     the adaptive and vertical round trips under backend="pallas" (K9
     and K8 in place of K3, the staged emission without a flip; frames
     byte-identical to the default ones); then K5b and K4 on the coder
     groups of those frames, read in place as the decode reads them, and
     K5a's x form on their RICE groups from the corpus's blocks (the main
     path's kernel times, the adaptive RICE group's 1351 blocks beside
     the rice path's 8192);
  4. drives the distribution layer on the same corpus: compress_sharded ->
     decompress_sharded of each coder over make_mesh() (the one card, in
     chunks of 2048 blocks) and of the adaptive coder over [cuda:0,
     cuda:0] (two shards, four chunks), each frame byte-identical to the
     coder's default frame and each round trip bit-exact, with the
     counters set to 0 around each: every kernel of the coder's default
     path once per block range and coder group (R once per range), no
     plain stage; then
     compress_multihost with two processes on the card, 8 streams each,
     under the "allgather" and the "files" gather, for the rice and the
     adaptive config (process 0's frame byte-identical to the rice frame,
     which is the reference's frame for both), each process with its own
     time limit; dryrun_multichip over every card; an EncodeJob of two
     parts whose merge equals the adaptive frame, and one RunMetrics line
     per coder; and the host feed: build_blocks' flat path against its
     per-stream loop over mean stream lengths 96-4096 at block lengths
     128 and 4096 (arrays equal, host times, the path build_blocks
     takes), and the corpus cut into 16384 streams of 2048 samples (both
     paths equal, decompress_flat equal to the input);
  5. builds the C++ oracle and checks, for each coder, that its frame of the
     same corpus is byte-identical to the port's and that it decodes the
     port's frame back to the input;
  6. runs the port's CLI (``python3 -m dctpu_torch.cli.main verify``, with
     the rice coder and with ``--sharded``) on the card as a subprocess;
  7. prints one JSON line of the kernels, then the result line.

Any failure exits non-zero. Without a CUDA device it fails; it never runs
on the CPU instead. ``chip_smoke.py --multihost-worker SPEC`` is one
process of a compress_multihost run (see multihost_worker); the tests
start it on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH_BLOCKS, BENCH_LEN = 8192, 4096
SHAPES = ((256, 4096), (BENCH_BLOCKS, BENCH_LEN), (256, 200), (32, 12000))
K_MAX = 24
# the bench corpus: 16 streams, 8192 blocks x 4096 int32 = 128 MiB in all
CORPUS = {"num_streams": 16, "samples_per_stream": BENCH_BLOCKS * BENCH_LEN // 16,
          "seed": 123, "mixed_cadence": True, "cumulative_frac": 0.25}
CODERS = ("adaptive", "rice", "vertical")
WRAP_COEFFS = (-(2**31),) * 4  # 4 * 2**62 on -2**31 samples: wraps int64
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, and the float32
# rate outside the tensor cores for the kernels' int32 ALU work (the card's
# int32 rate is no higher, so the bound stays a least time).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up. A
    device sleep ahead of them lets the host queue the launches, so that a
    kernel shorter than its wrapper's host time is timed on the device."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching tensors (integer outputs)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.long() - w.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def kernel_inputs(B: int, L: int, seed: int):
    """Seeded kernel inputs with the edge rows of the reference's tests."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = (rng.geometric(0.03, size=(B, L)) - 1).astype(np.uint32)
    z[0, :29] = 0xFFFFFFFF             # escape-heavy, max-width exceptions
    z[1] = 0                           # all-zero row
    z[2, 5] = 0x7FFFFFFF               # single huge exception
    z[4, :] = rng.integers(0, 4, size=L).astype(np.uint32)
    z[4, :16] = (1 << rng.integers(20, 31, size=16)).astype(np.uint32)
    S = -(-L // 128)
    for i in range(5, min(B, 22)):     # 0..16 exceptions per sub-block
        for s in range(S):
            cap = min(128, L - 128 * s)
            ne = min((i + s) % 17, cap)
            pos = 128 * s + rng.choice(cap, size=ne, replace=False)
            z[i, pos] = (1 << rng.integers(4, 31, size=ne)).astype(np.uint32)
    x = rng.integers(-(2**28), 2**28, size=(B, L)).astype(np.int32)
    x[::2] = (np.cumsum(rng.integers(-3, 4, size=(B, L)), axis=1)[::2]
              + 1000).astype(np.int32)  # smooth rows: small residuals
    x[0, :9] = np.int32(-(2**31))       # wrap-heavy residuals
    x[1] = 0
    hist = rng.integers(-(2**28), 2**28, size=(B, 4)).astype(np.int32)
    n = np.full(B, L, np.int32)
    n[-1] = max(1, L - 57)             # ragged tail
    n[-2] = 0                          # empty block
    n[3] = min(L, 128)                 # cut at a sub-block boundary
    k = (np.arange(B) % 28).astype(np.int32)  # every Rice k of the coders
    return x, z.view(np.int32), hist, n, k


def scatter_blocks(flat, wc, seed, gap=3):
    """The blocks' words (back to back in flat, wc[i] words each) laid out
    again in a shuffled order, each behind `gap` non-zero words of no
    block, with `gap` more at the end -> (words, start, count), on flat's
    device: the layout K4 and K5b are held to their twins on."""
    import numpy as np
    import torch

    from dctpu_torch.kernels import ragged

    rng = np.random.default_rng(seed)
    dev = flat.device
    wc = wc.to(torch.int64)
    order = torch.from_numpy(rng.permutation(wc.numel())).to(dev)
    room = wc[order] + gap
    start = torch.empty_like(wc)
    start[order] = torch.cumsum(room, 0) - wc[order]
    total = int(room.sum()) + gap
    junk = rng.integers(1, 2**32, size=total, dtype=np.uint64).astype(np.uint32)
    words = torch.from_numpy(junk.view(np.int32)).to(dev)
    ragged.copy_segments(words, start, flat, torch.cumsum(wc, 0) - wc, wc)
    return words, start, wc.clone()


def split_groups(z, seed):
    """z's rows dealt at random to two coder groups, each in a shuffled
    order -> (z of the first group, z of the second, src int32), on z's
    device: block b's row is first[src[b]] for src[b] >= 0 and
    second[-1 - src[b]] for src[b] < 0, the layout R's range form reads
    (blocks 0 and 1 fall in different groups)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B = z.shape[0]
    in_first = rng.random(B) < 0.5
    in_first[:2] = True, False
    src = np.empty(B, np.int32)
    parts = []
    for sel, first in ((in_first, True), (~in_first, False)):
        blocks = np.nonzero(sel)[0]
        order = rng.permutation(blocks.size)  # row order[i] holds blocks[i]
        src[blocks] = order if first else -1 - order
        rows = torch.empty((blocks.size, z.shape[1]), dtype=z.dtype,
                           device=z.device)
        rows[torch.from_numpy(order).to(z.device)] = z[
            torch.from_numpy(blocks).to(z.device)]
        parts.append(rows)
    return parts[0], parts[1], torch.from_numpy(src).to(z.device)


def bound(nbytes: float, ops: float):
    """(least ms on the card, what bounds it) for this many bytes moved
    (each input read once, each output written once) and integer ops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Integer work of the selection totals, the same for every implementation
# (the least the function needs, by the bit-length identity of select.cu):
# per valid sample and candidate, the bit length (clz, subtract), the three
# bits below the leading one (shift, shift, mask) and the four histogram
# counts; per block and candidate, a 33-bin suffix sum and ~24 ops per k
# for L(k); per 128-sample row and candidate (VERTICAL words), a 32-step
# suffix sum and ~9 ops for each of the 33 widths. The residuals derived
# from x add, per sample, DELTA + DOUBLE_DELTA 3 subtractions and 2
# zigzags (3 each), LPC 4 multiplies, 3 adds and a shift in 64 bits (2
# each), a subtraction and a zigzag.
LEN_OPS, K_OPS, ROW_OPS = 9, 24, 32 + 33 * 9
DELTAS_OPS, LPC_OPS = 3 + 2 * 3, 2 * (4 + 3 + 1) + 1 + 3
# VC's cost per valid sample and candidate: the bit length (clz,
# subtract) and the add to the sum, besides the residuals as above.
VC_OPS = 3
# The prediction of one sample (DELTA none; DOUBLE_DELTA a shift and a
# subtraction; LPC 4 multiplies, 3 adds and a shift in 64 bits), plus 4:
# the residual's subtraction and zigzag, or the unzigzag and the addition.
PRED_OPS = {0: 4, 1: 2 + 4, 2: 2 * (4 + 3 + 1) + 4}


def pred_ops(n, L, pred) -> int:
    """Prediction ops of each block's valid samples for its predictor."""
    v = n.clamp(0, L).long()
    return sum(c * int(v[pred == p].sum()) for p, c in PRED_OPS.items())


def work(key, B, L, n, b, rows_words, preds):
    """(bytes, ops) of kernel `key` on this run's inputs. ops count the
    integer work that the function needs: the selection totals as above
    (K1, K2, K2-lpc, K7; K6, K6-xbp, K6-lpc without the VERTICAL words),
    VC_OPS and the residuals' per valid sample and candidate for VC,
    64 per valid sample for K3's bit planes and exceptions (plus the
    chosen candidate's PRED_OPS in its x form, from preds), PRED_OPS per
    valid sample for R, 3 per decoded plane bit for K4, ~20 per codeword
    for the RICE pack (codeword, scan, ORs) and unpack (window, count,
    extract; plus the chosen candidate's PRED_OPS in K5a's x form), 4 per
    sub-block word for K8 (shift, compare, vote, rank) and 15 per word
    for K9 (the masked-swap network: 5 stages of 16 swaps of 6 ops per
    32 words). K3's output is its payload rows, rows_words["K3"] words,
    whole, and K5a's rows_words["K5a"]; K4 and K5b read the count_i words
    of each block, rows_words["K4"] and ["K5b"] in all, with its start
    (8 bytes) and count."""
    v = int(n.clamp(0, L).sum())
    K1 = K_MAX + 1
    R = B * -(-L // 128)
    sub_bytes = R * 4
    rice = v * LEN_OPS + B * (33 + K_OPS * K1)
    select = rice + R * ROW_OPS  # per candidate
    rows_out = 4 * rows_words["K3"] + 8 * B
    return {
        "K1": (4 * B * L + 16 * B + 4 * B + 8 * B * (K1 + 1),
               2 * select + v * DELTAS_OPS),
        "K2": (4 * B * L + 4 * B + 4 * B * (K1 + 1), select),
        "K2-lpc": (4 * B * L + 16 * B + 4 * B + 4 * B * (K1 + 1),
                   select + v * LPC_OPS),
        "K3": (4 * B * L + 16 * B + 8 * B + 20 * rows_words["cands"] + rows_out,
               v * 64 + pred_ops(n, L, preds["K3"])),
        "K3-z": (4 * B * L + 4 * B + rows_out, v * 64),
        "R": (8 * B * L + 16 * B + 16 * B + 16 * rows_words["tables"],
              pred_ops(n, L, preds["R"])),
        "K4": (4 * rows_words["K4"] + 16 * B + 4 * B + 4 * B * L,
               3 * 128 * int(b.sum())),
        "K5a": (4 * B * L + 16 * B + 12 * B + 20 * rows_words["cands"]
                + 4 * rows_words["K5a"] + 8 * B,
                20 * v + pred_ops(n, L, preds["K5a"])),
        "K5a-z": (4 * B * L + 8 * B + 4 * rows_words["K5a"] + 8 * B, 20 * v),
        "K5b": (4 * rows_words["K5b"] + 12 * B + 8 * B + 4 * B * L, 20 * v),
        "K6": (4 * B * L + 4 * B + 4 * B * K1, rice),
        "K6-xbp": (4 * B * L + 16 * B + 4 * B + 8 * B * K1,
                   2 * rice + v * DELTAS_OPS),
        "K6-lpc": (4 * B * L + 16 * B + 4 * B + 4 * B * K1,
                   rice + v * LPC_OPS),
        "K7": (4 * B * L + 4 * B + 4 * B * (K1 + 1), select),
        "VC-xbp": (4 * B * L + 16 * B + 4 * B + 4 * B * 2,
                   v * (2 * VC_OPS + DELTAS_OPS)),
        "VC-lpc": (4 * B * L + 16 * B + 4 * B + 4 * B, v * (VC_OPS + LPC_OPS)),
        "K8": (sub_bytes * (128 + 1 + 4 + 16), 4 * 128 * R),
        "K9": (sub_bytes * 128 * 2, 15 * 128 * R),
    }[key]


RECS = {
    "K1": ("K1 select_xbp", "dctpu_torch/csrc/select.cu",
           "dctpu/kernels/select_bp.py:221"),
    "K2": ("K2 select_bp", "dctpu_torch/csrc/select.cu",
           "dctpu/kernels/select_bp.py:206"),
    "K2-lpc": ("K2 select_lpc (LPC form)", "dctpu_torch/csrc/select.cu",
               "dctpu/kernels/select_bp.py:206"),
    "K3": ("K3 vemit_rows (x form)", "dctpu_torch/csrc/vemit.cu",
           "dctpu/kernels/vemit_pallas.py:116"),
    "K3-z": ("K3 vemit_rows_z (z form)", "dctpu_torch/csrc/vemit.cu",
             "dctpu/kernels/vemit_pallas.py:116"),
    "K4": ("K4 vdec_words", "dctpu_torch/csrc/vdec.cu",
           "dctpu/kernels/vdec_pallas.py:76"),
    "K5a": ("K5a rice_pack_rows (x form)", "dctpu_torch/csrc/pack.cu",
            "dctpu/kernels/attic/pack_pallas.py:72"),
    "K5a-z": ("K5a rice_pack (z form)", "dctpu_torch/csrc/pack.cu",
              "dctpu/kernels/attic/pack_pallas.py:72"),
    "K5b": ("K5b rice_unpack_words", "dctpu_torch/csrc/unpack.cu",
            "dctpu/kernels/attic/unpack_pallas.py:56"),
    "K6": ("K6 rice_totals", "dctpu_torch/csrc/select.cu",
           "dctpu/kernels/select_pallas.py:72"),
    "K6-xbp": ("K6 rice_totals_xbp (DELTA + DOUBLE_DELTA form)",
               "dctpu_torch/csrc/select.cu",
               "dctpu/kernels/select_pallas.py:72"),
    "K6-lpc": ("K6 rice_totals_lpc (LPC form)", "dctpu_torch/csrc/select.cu",
               "dctpu/kernels/select_pallas.py:72"),
    "K7": ("K7 select_reduce", "dctpu_torch/csrc/select.cu",
           "dctpu/kernels/select_pallas.py:79"),
    "K8": ("K8 exc_extract", "dctpu_torch/csrc/exc.cu",
           "dctpu/kernels/vertical_pallas.py:43"),
    "K9": ("K9 bit_planes32 (disk order)", "dctpu_torch/csrc/transpose.cu",
           "dctpu/kernels/transpose_pallas.py:83"),
    "R": ("R reconstruct", "dctpu_torch/csrc/recon.cu",
          "dctpu/codec/predict.py:93"),
    "VC-xbp": ("VC vertical_cost_xbp (DELTA + DOUBLE_DELTA form)",
               "dctpu_torch/csrc/select.cu",
               "dctpu/kernels/vertical_xla.py:263"),
    "VC-lpc": ("VC vertical_cost_lpc (LPC form)", "dctpu_torch/csrc/select.cu",
               "dctpu/kernels/vertical_xla.py:263"),
}


def recon_scaling(z, n, tidx, hist, coeffs) -> dict:
    """R's time with every block on one predictor, at B and at 512 blocks:
    a time that moves with neither is the chain of the walk, not device
    bandwidth and not the LPC arithmetic. Beside it, the DELTA case's
    yardstick: one torch.cumsum(dtype=torch.int32) over the same z, a
    prefix sum over the same bytes (the port never calls it). Returns
    {"ms_by_predictor": ..., "library_ms": the cumsum at B blocks}."""
    import torch

    from dctpu_torch.kernels.reconstruct import reconstruct

    out = {"ms_by_predictor": {}}
    for rows in (z.shape[0], 512):
        for pred in (0, 1, 2):
            p = torch.full((rows,), pred, dtype=torch.int32, device=z.device)
            args = (z[:rows], n[:rows], p, tidx[:rows], hist[:rows], coeffs)
            ms = time_ms(lambda: reconstruct(*args), 10)  # noqa: B023
            out["ms_by_predictor"][f"{rows}x{z.shape[1]} predictor {pred}"] = ms
            print(f"  R {rows}x{z.shape[1]}, every block predictor {pred}: "
                  f"{ms:.4f} ms", flush=True)
        zr = z[:rows]
        ms = time_ms(lambda: torch.cumsum(zr, 1, dtype=torch.int32), 10)  # noqa: B023
        if rows == z.shape[0]:
            out["library_ms"] = ms
        print(f"  torch.cumsum(dtype=int32) over the same z, {rows}x"
              f"{z.shape[1]} (DELTA's yardstick): {ms:.4f} ms", flush=True)
    return out


def check_kernels(dev):
    """Phase 2: each kernel against its twin; returns per-kernel records."""
    import torch

    from dctpu_torch._bits import to_i32
    from dctpu_torch.kernels.exc_extract import exc_extract, exc_extract_plain
    from dctpu_torch.kernels.pack import (
        rice_pack,
        rice_pack_plain,
        rice_pack_rows,
        rice_pack_rows_plain,
    )
    from dctpu_torch.kernels.rice_totals import (
        rice_totals,
        rice_totals_lpc,
        rice_totals_lpc_plain,
        rice_totals_plain,
        rice_totals_xbp,
        rice_totals_xbp_plain,
    )
    from dctpu_torch.config import DEFAULT_LPC_TABLES, CodecConfig, LpcTable
    from dctpu_torch.kernels.select_bp import (
        adaptive_totals_bp,
        adaptive_totals_bp_plain,
        adaptive_totals_lpc,
        adaptive_totals_lpc_plain,
        adaptive_totals_xbp,
        adaptive_totals_xbp_plain,
    )
    from dctpu_torch.kernels.select_reduce import (
        adaptive_totals_reduce,
        adaptive_totals_reduce_plain,
    )
    from dctpu_torch.kernels.transpose import bit_planes32, bit_planes32_plain
    from dctpu_torch.kernels import ragged
    from dctpu_torch.kernels.reconstruct import (
        reconstruct,
        reconstruct_range_plain,
    )
    from dctpu_torch.kernels.unpack import (
        rice_unpack_words,
        rice_unpack_words_plain,
    )
    from dctpu_torch.kernels.vdec import (
        decode_vertical_words,
        decode_vertical_words_plain,
        launch_vdec_words,
    )
    from dctpu_torch.kernels.vemit import (
        vertical_emit,
        vertical_emit_rows,
        vertical_emit_rows_plain,
        vertical_emit_rows_z,
        vertical_emit_rows_z_plain,
    )
    from dctpu_torch.kernels.vertical import assemble_rows, sub_rows
    from dctpu_torch.kernels.vertical_cost import (
        vertical_cost_lpc,
        vertical_cost_lpc_plain,
        vertical_cost_xbp,
        vertical_cost_xbp_plain,
    )

    recs = {
        key: dict(name=name, route="cuda", source=src, replaces=rep,
                  max_abs_err=0, library_ms=None)
        for key, (name, src, rep) in RECS.items()
    }
    K = K_MAX
    # K2-lpc, K6-lpc and VC-lpc are held against their twins with every default
    # table and one whose products wrap the int64 accumulator on the
    # -2**31 samples of row 0; they are timed with the first default table.
    # K3 and K5a's x form choose every candidate of those tables in turn,
    # block by block, K5a at k = i % 31 on block i; R gives block i
    # predictor i % 3 and table i // 3 % T, so that block 14 runs the wrap
    # table, here on -2**31 samples (a -2**31 history and residuals,
    # z = 0xFFFFFFFF), and runs in its range form: each block's z row read
    # from one of two coder groups, in shuffled orders (split_groups)
    tables = [t.coeffs for t in DEFAULT_LPC_TABLES] + [WRAP_COEFFS]
    extremes = torch.tensor([-(2**31), 2**31 - 1] * 2, dtype=torch.int32)
    for si, (B, L) in enumerate(SHAPES):
        x, z, hist, n, k = (
            torch.from_numpy(a).to(dev) for a in kernel_inputs(B, L, 100 + si)
        )
        emitted = vertical_emit(z, n, L)
        planes, b, vwords, n_exc, e, pos_words, vals = emitted
        rows = assemble_rows(planes, b, n_exc, e, pos_words, vals, L)
        cfg = CodecConfig(block_len=L, coder="vertical",
                          lpc_tables=tuple(LpcTable(4, c) for c in tables))
        cands = cfg.candidates()
        blocks = torch.arange(B, device=dev)
        choice = (blocks % len(cands)).to(torch.int32)
        k31 = (blocks % 31).to(torch.int32)
        pred_r = (blocks % 3).to(torch.int32)
        tidx = (blocks // 3 % len(tables)).to(torch.int32)
        coeffs = torch.tensor(tables, dtype=torch.int32, device=dev)
        hist_r = hist.clone()
        hist_r[::7] = extremes.to(dev)
        hist_r[14] = -(2**31)
        zr = z.clone()
        zr[14] = -1
        z_first, z_second, src = split_groups(zr, seed=400 + si)
        chosen = torch.tensor([p for p, _ in cands], device=dev)[choice.long()]
        preds = {"K3": chosen, "K5a": chosen, "R": pred_r}
        payload, bit_len = rice_pack_plain(z, k, n, L)
        # K5b and K4 read their blocks in place from the frame's compact
        # words, here shuffled between words of no block; three RICE
        # blocks are cut short (one below its sync table)
        r_words, r_start, r_count = scatter_blocks(
            ragged.compact_payload(payload, bit_len, L),
            ragged.payload_word_counts(bit_len, L), seed=200 + si)
        r_count[0] -= 5
        r_count[2] //= 2
        r_count[5] = 0
        v_words, v_start, v_count = scatter_blocks(
            *ragged.compact_vertical(rows, L), seed=300 + si)
        # K8 and K9 take the staged emission's inputs: the sub-block rows
        # (zero past n), with the width rule's b for K8 (b = 0 and 32 on two
        # blocks, so that ranks past EXC_CAP are dropped)
        zs = to_i32(sub_rows(z, n, L)).reshape(B, -1, 128)
        b_exc = b.clone()
        b_exc[0], b_exc[1] = 0, 32
        groups = zs.reshape(-1, 128)
        cases = {
            "K1": (lambda: adaptive_totals_xbp(x, hist, n, L, K),
                   lambda: adaptive_totals_xbp_plain(x, hist, n, L, K)),
            "K2": (lambda: adaptive_totals_bp(z, n, L, K),
                   lambda: adaptive_totals_bp_plain(z, n, L, K)),
            "K2-lpc": (
                lambda: [t for c in tables
                         for t in adaptive_totals_lpc(x, hist, n, c, L, K)],
                lambda: [t for c in tables
                         for t in adaptive_totals_lpc_plain(x, hist, n, c, L, K)],
            ),
            "K3": (lambda: vertical_emit_rows(x, hist_r, n, choice, cfg),
                   lambda: vertical_emit_rows_plain(x, hist_r, n, choice, cfg)),
            "K3-z": (lambda: vertical_emit_rows_z(z, n, L),
                     lambda: vertical_emit_rows_z_plain(z, n, L)),
            "K4": (lambda: (decode_vertical_words(v_words, v_start, v_count,
                                                  n, L),),
                   lambda: (decode_vertical_words_plain(v_words, v_start,
                                                        v_count, n, L),)),
            "K5a": (lambda: rice_pack_rows(x, hist_r, n, choice, k31, cfg),
                    lambda: rice_pack_rows_plain(x, hist_r, n, choice, k31, cfg)),
            "K5a-z": (lambda: rice_pack(z, k, n, L),
                      lambda: rice_pack_plain(z, k, n, L)),
            "K5b": (lambda: (rice_unpack_words(r_words, r_start, r_count, k,
                                               n, L),),
                    lambda: (rice_unpack_words_plain(r_words, r_start,
                                                     r_count, k, n, L),)),
            "K6": (lambda: (rice_totals(z, n, L, K),),
                   lambda: (rice_totals_plain(z, n, L, K),)),
            "K6-xbp": (lambda: (rice_totals_xbp(x, hist, n, L, K),),
                       lambda: (rice_totals_xbp_plain(x, hist, n, L, K),)),
            "K6-lpc": (
                lambda: [rice_totals_lpc(x, hist, n, c, L, K) for c in tables],
                lambda: [rice_totals_lpc_plain(x, hist, n, c, L, K)
                         for c in tables],
            ),
            "K7": (lambda: adaptive_totals_reduce(z, n, L, K),
                   lambda: adaptive_totals_reduce_plain(z, n, L, K)),
            "VC-xbp": (lambda: (vertical_cost_xbp(x, hist_r, n, L),),
                       lambda: (vertical_cost_xbp_plain(x, hist_r, n, L),)),
            "VC-lpc": (
                lambda: [vertical_cost_lpc(x, hist_r, n, c, L) for c in tables],
                lambda: [vertical_cost_lpc_plain(x, hist_r, n, c, L)
                         for c in tables],
            ),
            "K8": (lambda: exc_extract(zs, b_exc),
                   lambda: exc_extract_plain(zs, b_exc)),
            "K9": (lambda: (bit_planes32(groups),),
                   lambda: (bit_planes32_plain(groups),)),
            "R": (lambda: (reconstruct(z_first, n, pred_r, tidx, hist_r, coeffs,
                                       src=src, z1=z_second),),
                  lambda: (reconstruct_range_plain(z_first, n, pred_r, tidx,
                                                   hist_r, coeffs, src,
                                                   z_second),)),
        }
        for key, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            recs[key]["max_abs_err"] = max(recs[key]["max_abs_err"], err)
            print(f"  {key} {B}x{L}: max_abs_err {err}", flush=True)
            if err:
                fail(f"{key} differs from its twin at {B}x{L}")
            if key == "K4":
                bad_vertical_check(v_words, v_start, v_count, n, L)
            if (B, L) == (BENCH_BLOCKS, BENCH_LEN):
                r = recs[key]
                c0 = tables[0]
                if key == "K2-lpc":
                    kern = lambda: adaptive_totals_lpc(x, hist, n, c0, L, K)  # noqa: E731
                    plain = lambda: adaptive_totals_lpc_plain(x, hist, n, c0, L, K)  # noqa: E731
                if key == "K6-lpc":
                    kern = lambda: rice_totals_lpc(x, hist, n, c0, L, K)  # noqa: E731
                    plain = lambda: rice_totals_lpc_plain(x, hist, n, c0, L, K)  # noqa: E731
                if key == "VC-lpc":
                    kern = lambda: vertical_cost_lpc(x, hist_r, n, c0, L)  # noqa: E731
                    plain = lambda: vertical_cost_lpc_plain(x, hist_r, n, c0, L)  # noqa: E731
                if key == "K4":  # the kernel; the wrapper adds a host read
                    r["wrapper_ms"] = time_ms(kern, 10)
                    kern = lambda: launch_vdec_words(v_words, v_start, v_count, n, L)  # noqa: E731
                r["ms"] = time_ms(kern, 10)
                r["plain_ms"] = time_ms(plain, 3)
                words = {  # the live words, not the rows' padding
                    "K4": int(v_count.sum()),
                    "K5a": int(payload.numel()),
                    "K5a-z": int(payload.numel()),
                    "K5b": int(r_count.sum()),
                    "K3": int(rows.numel()),
                    "cands": len(cands),
                    "tables": len(tables),
                }
                nbytes, ops = work(key, B, L, n, b, words, preds)
                r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
                print(f"  {key} {B}x{L}: kernel {r['ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}: {nbytes} B, {ops} ops)", flush=True)
                if key == "R":
                    r.update(recon_scaling(zr, n, tidx, hist_r, coeffs))
        del x, z, hist, n, k, rows, planes, vwords, pos_words, vals, payload
        del r_words, r_start, r_count, v_words, v_start, v_count
        del zs, b_exc, groups, emitted, choice, pred_r, tidx, hist_r, zr, preds
        del z_first, z_second, src
        torch.cuda.empty_cache()
    return recs


def group_times(dev, frames, recs, streams) -> None:
    """K5b and K4 on the coder groups of the 128 MiB frames, each block read
    in place from its frame's words as the decode reads it, and K5a's x
    form on their RICE groups, from the corpus's blocks with each block's
    candidate and k from its frame: the main path's kernel times (K4
    without the wrapper's flag read), each beside the time its bytes take
    at the card's memory rate (K5b and K4: the words read, start, count,
    k and n, z written; K5a: x, history, n, k and choice read, the padded
    rows and bit_len written)."""
    import numpy as np
    import torch

    from dctpu_torch.codec.api import build_blocks
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.constants import LPC
    from dctpu_torch.format import read_frame
    from dctpu_torch.kernels.pack import padded_words, rice_pack_rows
    from dctpu_torch.kernels.unpack import rice_unpack_words
    from dctpu_torch.kernels.vdec import launch_vdec_words

    blocks = None
    for coder in CODERS:
        frame = read_frame(frames[coder])
        hb, L = frame.blocks, frame.block_len
        off = hb.word_offsets(L)
        words = torch.from_numpy(
            np.ascontiguousarray(frame.payload_words).view(np.int32)).to(dev)
        for gid, key in ((0, "K5b"), (1, "K4"), (0, "K5a")):
            idx = np.nonzero(hb.coder_arr() == gid)[0]
            if idx.size == 0:
                continue
            start, count, n, k = (
                torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev)
                for a in (off[:-1], np.diff(off).astype(np.int32),
                          hb.n.astype(np.int32), hb.k.astype(np.int32)))
            if key == "K5b":
                fn = lambda: rice_unpack_words(words, start, count, k, n, L)  # noqa: E731
                nbytes = 4 * int(count.sum()) + 20 * idx.size + 4 * idx.size * L
            elif key == "K4":
                fn = lambda: launch_vdec_words(words, start, count, n, L)  # noqa: E731
                nbytes = 4 * int(count.sum()) + 20 * idx.size + 4 * idx.size * L
            else:
                cfg = CodecConfig(block_len=L, lpc_tables=tuple(frame.tables))
                cand = {(p, ti if p == LPC else 0): ci
                        for ci, (p, ti) in enumerate(cfg.candidates())}
                choice_h = np.array([cand[p, t] for p, t in zip(
                    hb.predictor[idx].tolist(), hb.table_idx[idx].tolist())],
                    np.int32)
                if blocks is None:
                    blocks = build_blocks(streams, L)[:3]
                x, nx, hist = (torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev)
                               for a in blocks)
                choice = torch.from_numpy(choice_h).to(dev)
                fn = lambda: rice_pack_rows(x, hist, nx, choice, k, cfg)  # noqa: E731
                bl = fn()[1].cpu().numpy()
                if not np.array_equal(bl, hb.bit_len[idx]):
                    fail(f"K5a's x form on the {coder} RICE group gives other "
                         "bit lengths than the frame's")
                nbytes = (4 * idx.size * L + 28 * idx.size
                          + 20 * len(cfg.candidates())
                          + 4 * idx.size * padded_words(L) + 8 * idx.size)
            ms = time_ms(fn, 10)
            b_ms = nbytes / PEAK_BYTES_S * 1e3
            group = f"{coder} {'RICE' if gid == 0 else 'VERTICAL'} group"
            recs[key].setdefault("ms_by_group", {})[group] = ms
            print(f"  {key} on the {group}, {idx.size}x{L}: {ms:.4f} ms, bytes "
                  f"bound {b_ms:.4f} ms ({nbytes} B, {int(count.sum())} words)",
                  flush=True)


def bad_vertical_check(words, start, count, n, L) -> None:
    """K4 on the card raises the twin's ValueError for a block whose sync
    entry has a width above 32."""
    from dctpu_torch.kernels.vdec import decode_vertical_words

    bad = words.clone()
    bad[start[3]] = (bad[start[3]] & -(1 << 16)) | 40  # sub 0: b = 40
    try:
        decode_vertical_words(bad, start, count, n, L)
    except ValueError as e:
        if "sync table does not match" not in str(e):
            fail(f"K4 raised another ValueError on a bad sync entry: {e}")
    else:
        fail(f"K4 decoded a block with a bad sync entry at {L}")


def counters():
    """Each record's wrappers: "K2" counts both of K2's forms, "K6" all
    three of K6's."""
    from dctpu_torch.kernels import (
        exc_extract,
        pack,
        reconstruct,
        rice_totals,
        select_bp,
        select_reduce,
        transpose,
        unpack,
        vdec,
        vemit,
        vertical_cost,
    )

    return {
        "K1": (select_bp.adaptive_totals_xbp,),
        "K2": (select_bp.adaptive_totals_bp, select_bp.adaptive_totals_lpc),
        "K2-lpc": (select_bp.adaptive_totals_lpc,),
        "K3": (vemit.vertical_emit_rows,),
        "K3-z": (vemit.vertical_emit_rows_z,),
        "K4": (vdec.decode_vertical_words,),
        "K5a": (pack.rice_pack_rows,),
        "K5a-z": (pack.rice_pack,),
        "K5b": (unpack.rice_unpack_words,),
        "K6": (rice_totals.rice_totals, rice_totals.rice_totals_xbp,
               rice_totals.rice_totals_lpc),
        "K6-xbp": (rice_totals.rice_totals_xbp,),
        "K6-lpc": (rice_totals.rice_totals_lpc,),
        "K7": (select_reduce.adaptive_totals_reduce,),
        "K8": (exc_extract.exc_extract,),
        "K9": (transpose.bit_planes32,),
        "R": (reconstruct.reconstruct,),
        "VC-xbp": (vertical_cost.vertical_cost_xbp,),
        "VC-lpc": (vertical_cost.vertical_cost_lpc,),
    }


def reset_counters() -> None:
    for fns in counters().values():
        for fn in fns:
            fn.launches = 0


def read_counters() -> dict:
    return {k: sum(fn.launches for fn in fns) for k, fns in counters().items()}


# kernels each path must launch, and those it must not: the paths are
# (coder, backend)
NEEDS = {
    ("adaptive", None): ("K1", "K2", "K2-lpc", "K3", "K4", "K5a", "K5b", "R"),
    ("rice", None): ("K5a", "K5b", "K6-xbp", "K6-lpc", "R"),
    ("vertical", None): ("K3", "K4", "R", "VC-xbp", "VC-lpc"),
    ("adaptive", "pallas"): ("K1", "K2", "K2-lpc", "K4", "K5a", "K5b", "K8",
                             "K9", "R"),
    ("vertical", "pallas"): ("K4", "K8", "K9", "R", "VC-xbp", "VC-lpc"),
}
NEVER = {
    ("adaptive", None): ("K3-z", "K5a-z", "K9", "VC-xbp", "VC-lpc"),
    ("rice", None): ("K5a-z", "VC-xbp", "VC-lpc"),
    ("vertical", None): ("K3-z", "K5a-z", "K9"),
    ("adaptive", "pallas"): ("K3", "K3-z", "K5a-z", "VC-xbp", "VC-lpc"),
    ("vertical", "pallas"): ("K3", "K3-z", "K5a-z"),
}


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the plain torch stages that R, K3, K4, K5a, K5b
    and VC replace on the default paths: the LPC recurrence loop, the
    region assembly, the winner's residuals of an emission (a VERTICAL
    group's on the staged backends only), the staging of the decode's
    VERTICAL and RICE rows, and the VERTICAL selection cost (VC's twin
    too); and the flips in the staged VERTICAL emission, which K9 no
    longer needs."""
    import torch

    from dctpu_torch.codec import encode, predict
    from dctpu_torch.kernels import ragged, vemit, vertical, vertical_cost

    counts = {"reconstruct_lpc": 0, "assemble_rows": 0, "chosen_residuals": 0,
              "stage_vertical": 0, "pad_payload": 0,
              "vertical_selection_cost": 0, "staged_flip": 0}
    patched = [(predict, "reconstruct_lpc"), (encode, "assemble_rows"),
               (vemit, "assemble_rows"), (predict, "chosen_residuals"),
               (ragged, "stage_vertical"), (ragged, "pad_payload"),
               (vertical, "vertical_selection_cost"),
               (vertical_cost, "vertical_selection_cost")]
    saved = [getattr(mod, name) for mod, name in patched]

    def counting(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    flips = [(torch.Tensor, "flip"), (torch, "flip")]
    staged = encode._emit_staged

    def staged_flips(*args):
        saved_flips = [getattr(mod, name) for mod, name in flips]
        for (mod, name), fn in zip(flips, saved_flips):
            setattr(mod, name, counting("staged_flip", fn))
        try:
            return staged(*args)
        finally:
            for (mod, name), fn in zip(flips, saved_flips):
                setattr(mod, name, fn)

    for (mod, name), fn in zip(patched, saved):
        setattr(mod, name, counting(name, fn))
    encode._emit_staged = staged_flips
    try:
        yield counts
    finally:
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)
        encode._emit_staged = staged


@contextlib.contextmanager
def peak_bytes(dev, out: dict, key: str):
    """out[key] = the peak device bytes allocated inside the block above
    those allocated when it starts (torch.cuda.max_memory_allocated)."""
    import torch

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    yield
    torch.cuda.synchronize(dev)
    out[key] = torch.cuda.max_memory_allocated(dev) - before


def segments() -> int:
    """Device memory segments the caching allocator has obtained so far
    (one cudaMalloc each)."""
    import torch

    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def path_name(coder, backend) -> str:
    return coder if backend is None else f"{coder}/{backend}"


def run_path(dev, coder, streams, ids, cads, backend=None):
    """Phase 3, one coder and backend: the 128 MiB round trip. Returns
    (frame bytes, launches per kernel, compress+write_frame seconds)."""
    import numpy as np
    import torch

    from dctpu_torch.codec.api import compress, decompress
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.format import read_frame, write_frame

    cfg = CodecConfig(coder=coder)
    # warm-up on a small corpus (CUDA context, allocator), not counted
    warm, _, _ = synth_corpus(2, 3 * BENCH_LEN, seed=7)
    decompress(read_frame(write_frame(
        compress(warm, cfg, device=dev, backend=backend))), device=dev)

    raw_bytes = sum(s.nbytes for s in streams)
    name = path_name(coder, backend)
    reset_counters()
    enc_ms, dec_ms = {}, {}
    torch.cuda.synchronize()
    seg0 = segments()
    peak = {}
    with plain_calls() as plain:
        t0 = time.perf_counter()
        with peak_bytes(dev, peak, "compress"):
            frame = compress(streams, cfg, ids, cads, device=dev,
                             stage_ms=enc_ms, backend=backend)
        seg1 = segments()
        data = write_frame(frame)
        t1 = time.perf_counter()
        with peak_bytes(dev, peak, "decompress"):
            out = decompress(read_frame(data), device=dev, stage_ms=dec_ms)
        t2 = time.perf_counter()
    launches = read_counters()

    if len(out) != len(streams) or not all(
        np.array_equal(a, b) for a, b in zip(streams, out)
    ):
        fail(f"128 MiB {name} round trip is not bit-exact")
    hist = np.bincount(frame.blocks.coder_arr(), minlength=2)
    print(f"{name} path: {frame.blocks.num_blocks} blocks x {BENCH_LEN}, "
          f"{raw_bytes} bytes -> {len(data)} bytes, ratio "
          f"{raw_bytes / len(data):.4f}, RICE {hist[0]} / VERTICAL {hist[1]} "
          f"blocks, round trip bit-exact")
    print(f"{name} path: compress+write_frame {1e3 * (t1 - t0):.1f} ms "
          f"({raw_bytes / (t1 - t0) / 1e9:.3f} GB/s), read_frame+decompress "
          f"{1e3 * (t2 - t1):.1f} ms ({raw_bytes / (t2 - t1) / 1e9:.3f} GB/s), "
          f"host clock")
    print(f"{name} path encode stages (CUDA events, ms; {seg1 - seg0} new "
          "device segments): "
          + json.dumps({k: round(v, 3) for k, v in enc_ms.items()}))
    print(f"{name} path peak device bytes per input byte (max_memory_allocated "
          "above the bytes allocated before the call): "
          + json.dumps({k: v / raw_bytes for k, v in peak.items()}))
    if (coder, backend) == ("adaptive", None):
        # the same compress again, on the allocator's cached segments
        again, seg2 = {}, segments()
        compress(streams, cfg, ids, cads, device=dev, stage_ms=again)
        print(f"{name} path encode stages, second compress ({segments() - seg2}"
              " new device segments): "
              + json.dumps({k: round(v, 3) for k, v in again.items()}))
    print(f"{name} path decode stages (CUDA events, ms): "
          + json.dumps({k: round(v, 3) for k, v in dec_ms.items()}))
    print(f"{name} path kernel launches: {json.dumps(launches)}; plain "
          f"stage calls: {json.dumps(plain)}", flush=True)
    if cfg.coder == "adaptive" and (hist[0] == 0 or hist[1] == 0):
        fail(f"expected both coder groups, got {hist.tolist()}")
    missing = [k for k in NEEDS[cfg.coder, backend] if launches[k] == 0]
    if missing:
        fail(f"kernels not launched on the {name} path: {missing}")
    extra = [k for k in NEVER.get((cfg.coder, backend), ()) if launches[k]]
    if extra:
        fail(f"kernels launched on the {name} path that it replaces: {extra}")
    staged = backend is not None
    staged_vert = int(staged and hist[1] > 0)
    want_plain = {"reconstruct_lpc": 0, "assemble_rows": staged_vert,
                  "chosen_residuals": staged_vert, "stage_vertical": 0,
                  "pad_payload": 0, "vertical_selection_cost": 0,
                  "staged_flip": 0}
    if (launches["R"], launches["K3"], plain) != (
            1, 0 if staged else int(hist[1] > 0), want_plain):
        fail(f"R launched {launches['R']} times (want 1, one per decode "
             f"range), K3 {launches['K3']}, plain stages {plain} (want "
             f"{want_plain})")
    if (launches["K5b"], launches["K4"]) != (int(hist[0] > 0), int(hist[1] > 0)):
        fail(f"K5b launched {launches['K5b']} times (want one per RICE group), "
             f"K4 {launches['K4']} (want one per VERTICAL group)")
    if (launches["K5a"], launches["K9"]) != (int(hist[0] > 0), staged_vert):
        fail(f"K5a's x form launched {launches['K5a']} times (want one per "
             f"RICE group), K9 {launches['K9']} (want {staged_vert})")
    stages = [k for k in dec_ms if k.startswith("stage_")]
    if stages:
        fail(f"the {name} decode still stages rows: {stages}")
    n_lpc = len(cfg.candidates()) - 2
    if cfg.coder == "rice":
        z_form = launches["K6"] - launches["K6-xbp"] - launches["K6-lpc"]
        if (launches["K6-xbp"], launches["K6-lpc"], z_form) != (1, n_lpc, 0):
            fail(f"K6-xbp launched {launches['K6-xbp']} times (want 1), "
                 f"K6-lpc {launches['K6-lpc']} (want {n_lpc}), K6's z form "
                 f"{z_form} (want 0)")
    if cfg.coder == "vertical" and (
            launches["VC-xbp"], launches["VC-lpc"]) != (1, n_lpc):
        fail(f"VC-xbp launched {launches['VC-xbp']} times (want 1), VC-lpc "
             f"{launches['VC-lpc']} (want {n_lpc})")
    if cfg.coder == "adaptive" and (launches["K1"], launches["K2-lpc"]) != (1, n_lpc):
        fail(f"K1 launched {launches['K1']} times (want 1), K2's LPC form "
             f"{launches['K2-lpc']} (want {n_lpc})")
    return data, launches, t1 - t0


def one_range_check(dev) -> None:
    """The default pass (chunk_blocks None) on this card: the blocks of a
    range by api.range_blocks from the card's total memory; the 128 MiB
    corpus must be one range (each path above launched R once)."""
    from dctpu_torch.codec import api

    total = api.device_memory([dev])
    blocks = api.range_blocks(None, total, BENCH_LEN)
    print(f"default pass on this card: ranges of {blocks} blocks of "
          f"{BENCH_LEN} samples ({total} bytes of device memory, "
          f"{api.DEVICE_BYTES_PER_SAMPLE} bytes a sample, 1/"
          f"{api.DEVICE_SHARE} of it)", flush=True)
    if blocks < BENCH_BLOCKS:
        fail(f"the {BENCH_BLOCKS}-block corpus is more than one default range")


def reduce_select_check(dev, streams) -> dict:
    """Phase 3, backend="reduce": adaptive selection of the 128 MiB corpus
    with K7 for every candidate equals the default selection (K1 + K2).
    Returns the launches of the "reduce" run."""
    import torch

    from dctpu_torch.codec.api import build_blocks
    from dctpu_torch.codec.encode import adaptive_select
    from dctpu_torch.config import CodecConfig

    cfg = CodecConfig(coder="adaptive")
    x, n, hist = (torch.from_numpy(a).to(dev)
                  for a in build_blocks(streams, cfg.block_len)[:3])
    adaptive_select(x, n, hist, cfg, backend="reduce")  # warm-up, not counted
    got, ms = {}, {}
    for backend in (None, "reduce"):
        torch.cuda.synchronize()
        reset_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got[backend] = adaptive_select(x, n, hist, cfg, backend=backend)
        end.record()
        torch.cuda.synchronize()
        ms[backend] = start.elapsed_time(end)
    launches = read_counters()  # of the "reduce" run, the last one
    for a, b in zip(got[None], got["reduce"]):
        if not torch.equal(a, b):
            fail("adaptive selection under backend='reduce' differs from the default")
    C = len(cfg.candidates())
    print(f"adaptive/reduce selection: equal to the default selection, "
          f"{int(x.shape[0])} blocks; select {ms['reduce']:.3f} ms (default "
          f"{ms[None]:.3f} ms), CUDA events; launches {json.dumps(launches)}",
          flush=True)
    if launches["K7"] != C or launches["K1"] or launches["K2"]:
        fail(f"backend='reduce' selection launched K7 {launches['K7']} times "
             f"(want {C}), K1 {launches['K1']}, K2 {launches['K2']} (want 0)")
    return launches


def zform_emit_check(dev, streams, coder) -> dict:
    """Phase 3, the z forms: the emission of the 128 MiB corpus under the
    coder's single-coder selection, through the reference's signature on
    the winner's zigzag values (VERTICAL: ``encode_vertical``, K3's z
    form; RICE: ``rice_pack``, K5a's z form), equals the default emission
    (the x form). Returns the launches of the z-form run."""
    import torch

    from dctpu_torch.codec import encode, predict, rice
    from dctpu_torch.codec.api import build_blocks
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.kernels.pack import rice_pack

    cfg = CodecConfig(coder=coder)
    L = cfg.block_len
    x, n, hist = (torch.from_numpy(a).to(dev)
                  for a in build_blocks(streams, L)[:3])
    choice, k = encode.select_blocks(x, n, hist, cfg)
    z = rice.zigzag(predict.chosen_residuals(
        x, hist, choice, predict.candidate_coeffs(cfg)))
    want = encode.emit_blocks(x, n, hist, choice, k, cfg, coder)
    if coder == "vertical":
        name, key, x_key = "encode_vertical", "K3-z", "K3"
        emit = lambda: encode.encode_vertical(z, n, L)  # noqa: E731
    else:
        name, key, x_key = "rice_pack", "K5a-z", "K5a"
        emit = lambda: rice_pack(z, k, n, L)  # noqa: E731
    emit()  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = emit()
    end.record()
    torch.cuda.synchronize()
    launches = read_counters()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"{key}'s rows differ from the x form's at 128 MiB")
    print(f"{coder}/z-form emission: rows equal to the default emission's, "
          f"{int(x.shape[0])} blocks; {name} {start.elapsed_time(end):.3f}"
          f" ms, CUDA events; launches {json.dumps(launches)}", flush=True)
    if launches[key] != 1 or launches[x_key]:
        fail(f"{name} launched {key} {launches[key]} times (want 1), "
             f"{x_key} {launches[x_key]} (want 0)")
    return launches


def oracle_check(streams, ids, cads, frames) -> None:
    """Phase 4: the C++ oracle's frame == the port's frame, per coder."""
    import numpy as np

    from dctpu_torch.format import read_raw, write_raw

    res = subprocess.run(["make", "-C", str(ROOT / "oracle")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"oracle build failed (make exit {res.returncode}): "
             f"{res.stderr.strip()[-300:]}")
    oracle = str(ROOT / "oracle" / "dcomp_oracle")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "in.dcr").write_bytes(write_raw(streams, ids, cads))
        for coder, data in frames.items():
            t0 = time.perf_counter()
            subprocess.run([oracle, "encode", str(tmp / "in.dcr"),
                            str(tmp / "oracle.dcf"), "--coder", coder],
                           check=True, capture_output=True)
            t1 = time.perf_counter()
            if (tmp / "oracle.dcf").read_bytes() != data:
                fail(f"oracle {coder} frame differs from the port's frame")
            (tmp / "port.dcf").write_bytes(data)
            subprocess.run([oracle, "decode", str(tmp / "port.dcf"),
                            str(tmp / "out.dcr")], check=True, capture_output=True)
            out, _, _ = read_raw((tmp / "out.dcr").read_bytes())
            if not all(np.array_equal(a, b) for a, b in zip(streams, out)):
                fail(f"oracle does not decode the port's {coder} frame")
            print(f"oracle: {coder} frame byte-identical to the port's "
                  f"({len(data)} bytes, oracle encode {t1 - t0:.1f} s), oracle "
                  f"decodes the port's frame bit-exact", flush=True)


def cli_check() -> None:
    """Phase 5: the port's CLI verifies a small DCR1 file on the card, with
    the rice coder and with the default coder over ``--sharded``."""
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.format import write_raw

    streams, ids, cads = synth_corpus(4, 20000, seed=31, mixed_cadence=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "in.dcr"
        src.write_bytes(write_raw(streams, ids, cads))
        for flags in (["--coder", "rice"], ["--sharded"]):
            res = subprocess.run(
                [sys.executable, "-m", "dctpu_torch.cli.main", "verify",
                 str(src), *flags],
                cwd=ROOT, capture_output=True, text=True, timeout=300,
                env={**os.environ, "PYTHONPATH": str(ROOT)},
            )
            print(f"cli: verify {' '.join(flags)} exit {res.returncode}: "
                  f"{res.stderr.strip()[-200:]}", flush=True)
            if res.returncode != 0:
                fail(f"the CLI's verify {' '.join(flags)} failed on the card")


# ------------------------------------------------ the distribution layer


def range_launches(coder, coders, ranges, n_lpc) -> dict:
    """The launches of a sharded round trip whose encode and decode each
    cover these block ranges, one pass per range: every kernel of the
    coder's default path once per range and coder group (K2, K6 and
    VC-lpc once per LPC candidate too, K6-xbp and VC-xbp once), R once per
    range, and none of the z forms, K7, K8 or K9."""
    rice = sum(int((coders[a:b] == 0).any()) for a, b in ranges)
    vert = sum(int((coders[a:b] == 1).any()) for a, b in ranges)
    r = len(ranges)
    adaptive, rice_sel = coder == "adaptive", coder == "rice"
    vert_sel = coder == "vertical"
    return {
        "K1": r * adaptive, "K2": r * n_lpc * adaptive,
        "K2-lpc": r * n_lpc * adaptive, "K3": vert, "K3-z": 0, "K4": vert,
        "K5a": rice, "K5a-z": 0, "K5b": rice, "K6": r * (1 + n_lpc) * rice_sel,
        "K6-xbp": r * rice_sel, "K6-lpc": r * n_lpc * rice_sel, "K7": 0,
        "K8": 0, "K9": 0, "R": r, "VC-xbp": r * vert_sel,
        "VC-lpc": r * n_lpc * vert_sel,
    }


def run_sharded(coder, streams, ids, cads, mesh, chunk_blocks, want) -> dict:
    """Phase 3b, one sharded round trip of the 128 MiB corpus over mesh:
    compress_sharded -> write_frame -> read_frame -> decompress_sharded
    with the launch counters set to 0 just before and read just after.
    The frame must equal the default path's (want), the round trip be
    bit-exact, the launches those of range_launches, and no plain stage
    run. Returns the launches."""
    import numpy as np
    import torch

    from dctpu_torch.codec.api import block_ranges, shard_ranges
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.dist import compress_sharded, decompress_sharded
    from dctpu_torch.format import read_frame, write_frame

    cfg = CodecConfig(coder=coder)
    name = f"{coder}/sharded {len(mesh)}x{chunk_blocks}"
    raw_bytes = sum(s.nbytes for s in streams)
    enc_ms, dec_ms = {}, {}
    torch.cuda.synchronize()
    reset_counters()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        frame = compress_sharded(streams, cfg, mesh, ids, cads,
                                 chunk_blocks=chunk_blocks, stage_ms=enc_ms)
        data = write_frame(frame)
        t1 = time.perf_counter()
        out = decompress_sharded(read_frame(data), mesh,
                                 chunk_blocks=chunk_blocks, stage_ms=dec_ms)
        t2 = time.perf_counter()
    launches = read_counters()
    if data != want:
        fail(f"the {name} frame differs from the default {coder} frame")
    if len(out) != len(streams) or not all(
            np.array_equal(a, b) for a, b in zip(streams, out)):
        fail(f"the {name} round trip is not bit-exact")
    coders = frame.blocks.coder_arr()
    ranges = [(a, b) for c0, c1 in block_ranges(coders.size, chunk_blocks)
              for _, a, b in shard_ranges(c0, c1, len(mesh))]
    print(f"{name} path: frame byte-identical to the {coder} frame, round "
          f"trip bit-exact, {len(ranges)} block ranges; compress+write_frame "
          f"{1e3 * (t1 - t0):.1f} ms ({raw_bytes / (t1 - t0) / 1e9:.3f} GB/s), "
          f"read_frame+decompress {1e3 * (t2 - t1):.1f} ms "
          f"({raw_bytes / (t2 - t1) / 1e9:.3f} GB/s), host clock")
    print(f"{name} path encode stages (CUDA events, ms): "
          + json.dumps({k: round(v, 3) for k, v in enc_ms.items()}))
    print(f"{name} path decode stages (CUDA events, ms): "
          + json.dumps({k: round(v, 3) for k, v in dec_ms.items()}))
    print(f"{name} path kernel launches: {json.dumps(launches)}; plain stage "
          f"calls: {json.dumps(plain)}", flush=True)
    want_launches = range_launches(coder, coders, ranges,
                                   len(cfg.candidates()) - 2)
    if launches != want_launches:
        fail(f"the {name} path launched {launches}, want {want_launches}")
    if any(plain.values()):
        fail(f"plain stages ran on the {name} path: {plain}")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_worker(spec: dict) -> None:
    """One process of a compress_multihost run, started by run_multihost
    as ``chip_smoke.py --multihost-worker SPEC`` (SPEC a JSON object): it
    joins the gloo group at spec["coordinator"] as spec["rank"] of
    spec["nproc"], encodes its contiguous share of
    synth_corpus(**spec["corpus"]) with CodecConfig(spec["block_len"],
    coder=spec["coder"]) on spec["device"] (None: compress_multihost's
    default device), and prints one JSON line: its stats, its host ms and
    its kernel launches. Process 0 writes the frame to spec["out"]."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from dctpu_torch.config import CodecConfig
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.dist import multihost
    from dctpu_torch.format import write_frame

    rank, nproc = spec["rank"], spec["nproc"]
    multihost.initialize(spec["coordinator"], nproc, rank)
    try:
        streams, ids, cads = synth_corpus(**spec["corpus"])
        per = len(streams) // nproc
        lo, hi = rank * per, (rank + 1) * per
        cfg = CodecConfig(block_len=spec["block_len"], coder=spec["coder"])
        reset_counters()
        t0 = time.perf_counter()
        frame, stats = multihost.compress_multihost(
            streams[lo:hi], cfg, ids[lo:hi], cads[lo:hi],
            gather=spec["gather"], parts_dir=spec.get("parts_dir"),
            device=spec["device"])
        ms = 1e3 * (time.perf_counter() - t0)
        if rank == 0:
            Path(spec["out"]).write_bytes(write_frame(frame))
        print(json.dumps({"rank": rank, "ms": ms, "launches": read_counters(),
                          **stats}), flush=True)
    finally:
        dist.destroy_process_group()


def run_multihost(spec: dict, nproc: int, timeout: float):
    """Runs nproc multihost_worker processes over localhost with spec (plus
    their coordinator, count and rank). Returns (each rank's JSON line,
    wall seconds). Raises RuntimeError when a worker fails or outlives its
    time limit of timeout seconds; every worker has ended by then."""
    spec = {**spec, "coordinator": f"127.0.0.1:{free_port()}", "nproc": nproc}
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
             json.dumps({**spec, "rank": rank})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(nproc)
    ]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"a multihost worker outlived {timeout} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    bad = [(rank, p.returncode, err[-2000:])
           for rank, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"multihost workers failed (rank, exit, stderr): {bad}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs], seconds


def multihost_check(frames, corpus) -> dict:
    """Phase 3c: compress_multihost with two processes on the card, each
    taking 8 of the 16 streams, under the "allgather" and the "files"
    gather, for the rice and the adaptive config: process 0's frame is
    byte-identical to the rice path's (the reference's all-RICE frame for
    coder="adaptive"), and the part files hold the payload section.
    Returns each run's launches, summed over the processes."""
    from dctpu_torch.format import read_frame

    by_path = {}
    for coder in ("rice", "adaptive"):
        for gather in ("allgather", "files"):
            with tempfile.TemporaryDirectory() as tmp:
                spec = {"corpus": corpus, "block_len": BENCH_LEN,
                        "coder": coder, "gather": gather, "device": None,
                        "out": str(Path(tmp) / "frame.dcf"),
                        "parts_dir": str(Path(tmp) / "parts")
                        if gather == "files" else None}
                try:
                    lines, seconds = run_multihost(spec, 2, timeout=300)
                except RuntimeError as e:
                    fail(f"compress_multihost {coder}/{gather}: {e}")
                data = Path(spec["out"]).read_bytes()
                parts = sum(f.stat().st_size
                            for f in Path(tmp).glob("parts/payload-*.u32"))
            name = f"{coder}/multihost-{gather}"
            if data != frames["rice"]:
                fail(f"the {name} frame differs from the rice frame")
            if gather == "files" and parts != read_frame(data).payload_words.nbytes:
                fail(f"{name}: part files hold {parts} bytes, the payload "
                     f"section {read_frame(data).payload_words.nbytes}")
            launches = {k: sum(line["launches"][k] for line in lines)
                        for k in lines[0]["launches"]}
            by_path[name] = launches
            print(f"{name}, 2 processes on the card: frame byte-identical to "
                  f"the rice frame; compress_multihost host ms per process "
                  f"{[round(line['ms'], 1) for line in lines]}, wall "
                  f"{seconds:.2f} s with process start-up; stats "
                  f"{json.dumps({k: lines[0][k] for k in ('global_blocks', 'local_blocks', 'compressed_words')})}; "
                  f"launches {json.dumps(launches)}", flush=True)
            got = [launches[k] for k in ("K6-xbp", "K5a", "K5b", "R")]
            if got != [2, 2, 0, 0]:
                fail(f"{name}: K6-xbp, K5a, K5b, R launched {got} times "
                     "(want K6-xbp and K5a once in each process, the decode "
                     "kernels never)")
    return by_path


def aux_check(dev, streams, ids, cads, frames, enc_s) -> None:
    """Phase 3d: dryrun_multichip over every card; an EncodeJob of two
    parts on the card whose merge equals the adaptive frame and decodes
    bit-exact; one RunMetrics line per coder."""
    import numpy as np
    import torch

    from dctpu_torch.codec.api import decompress
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.dist import dryrun_multichip
    from dctpu_torch.format import read_frame
    from dctpu_torch.utils import EncodeJob, RunMetrics

    t0 = time.perf_counter()
    dryrun_multichip(torch.cuda.device_count())
    print(f"dryrun_multichip({torch.cuda.device_count()}): passed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        job = EncodeJob(Path(tmp) / "job", CodecConfig(coder="adaptive"), dev)
        half = len(streams) // 2
        t0 = time.perf_counter()
        job.encode_part("0", streams[:half], ids[:half], cads[:half])
        job.encode_part("1", streams[half:], ids[half:], cads[half:])
        merged = job.merge(Path(tmp) / "merged.dcf").read_bytes()
        t1 = time.perf_counter()
    if merged != frames["adaptive"]:
        fail("the EncodeJob's merged frame differs from the adaptive frame")
    out = decompress(read_frame(merged), device=dev)
    if not all(np.array_equal(a, b) for a, b in zip(streams, out)):
        fail("the EncodeJob's merged frame does not decode bit-exact")
    print(f"EncodeJob: two parts on the card and merge in {1e3 * (t1 - t0):.1f}"
          " ms (host clock), merged frame byte-identical to the adaptive "
          "frame, decodes bit-exact", flush=True)
    for coder in CODERS:
        m = RunMetrics.from_frame(read_frame(frames[coder]), "encode",
                                  enc_s[coder], len(frames[coder]))
        print(f"RunMetrics {coder}: {m.to_json()}", flush=True)


# (block length, mean stream lengths) of the host feed sweep: the bench
# geometry, and the reference's host feed bench (bench/host_feed.py,
# 1 M streams of mean 96 at L=128) at a smaller stream count
FEED_SWEEP = ((BENCH_LEN, (96, 512, 1024, 2048, 4096)), (128, (96, 512, 1024, 2048)))


def host_feed_sweep(total: int = 1 << 22, reps: int = 2) -> None:
    """build_blocks' two host paths on about ``total`` samples of streams
    of mean length m (lengths uniform in 1..2m-1), for each (L, m) of
    FEED_SWEEP: arrays equal, the best of ``reps`` host times of each path
    on this machine's CPU, and the path build_blocks takes. Needs no
    card."""
    import numpy as np

    from dctpu_torch.codec import api

    rng = np.random.default_rng(11)
    for L, means in FEED_SWEEP:
        for mean in means:
            lens = rng.integers(1, 2 * mean, size=max(total // mean, 1))
            flat = rng.integers(-(2**15), 2**15, size=int(lens.sum()),
                                dtype=np.int32)
            streams = np.split(flat, np.cumsum(lens)[:-1])
            ms, out = {}, {}
            for name, fn in (
                ("flat", lambda: api.build_blocks_flat(
                    np.concatenate(streams), lens, L)),
                ("loop", lambda: api.build_blocks_loop(streams, L)),
            ):
                ms[name] = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    out[name] = fn()
                    ms[name] = min(ms[name], 1e3 * (time.perf_counter() - t0))
            if not all(np.array_equal(a, b) for a, b in zip(out["flat"], out["loop"])):
                fail(f"build_blocks' flat path differs from the loop at L={L}, "
                     f"mean {mean}")
            takes = "flat" if api.takes_flat_path(lens) else "loop"
            print(f"host feed L={L}, {lens.size} streams of mean {mean} samples:"
                  f" flat path {ms['flat']:.1f} ms (with the concatenation), "
                  f"loop {ms['loop']:.1f} ms (best of {reps}, host times of the "
                  f"card machine's CPU), arrays equal; build_blocks takes the "
                  f"{takes} path", flush=True)


def flat_feed_check(dev, streams) -> None:
    """Phase 3e: the host feed sweep; then the 128 MiB corpus cut into
    16384 streams of 2048 samples, whose flat-path arrays equal the
    per-stream loop's, and decompress_flat of their adaptive frame equals
    the concatenation. Host times are of the card machine's CPU."""
    import numpy as np

    from dctpu_torch.codec import api
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.format import read_frame, write_frame

    host_feed_sweep()
    flat = np.concatenate(streams)
    short = np.split(flat, flat.size // 2048)
    lens = np.full(len(short), 2048, np.int64)
    t0 = time.perf_counter()
    got = api.build_blocks_flat(np.concatenate(short), lens, BENCH_LEN)
    t1 = time.perf_counter()
    want = api.build_blocks_loop(short, BENCH_LEN)
    t2 = time.perf_counter()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        fail("build_blocks' flat path differs from the per-stream loop")
    frame = read_frame(write_frame(api.compress(
        short, CodecConfig(coder="adaptive"), device=dev)))
    t3 = time.perf_counter()
    out, lens = api.decompress_flat(frame, device=dev)
    t4 = time.perf_counter()
    split = api.decompress(frame, device=dev)
    t5 = time.perf_counter()
    if not (np.array_equal(out, flat) and np.all(lens == 2048)
            and all(np.array_equal(a, b) for a, b in zip(split, short))):
        fail("decompress_flat of the 16384-stream frame differs from the input")
    print(f"host feed, {len(short)} streams x 2048 samples: build_blocks "
          f"flat path {1e3 * (t1 - t0):.1f} ms (with the concatenation), "
          f"per-stream loop {1e3 * (t2 - t1):.1f} ms (host times of the card "
          f"machine's CPU), arrays equal; decompress_flat "
          f"{1e3 * (t4 - t3):.1f} ms, decompress {1e3 * (t5 - t4):.1f} ms "
          "(host clock), equal to the input", flush=True)


def ptxas_report(log: str) -> dict:
    """{kernel: "N registers, smem, spill"} from the nvcc -Xptxas=-v log;
    a dct::...<Src i, VERT> template shows as "name<Src i, true|false>",
    a dct::...<Src i> one as "name<Src i>", a dct::...<bool, ...> one as
    "name<true|false, ...>"."""
    import re

    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            short = re.match(r"_ZN3dct(\d+)", mangled)
            name = (mangled[short.end():short.end() + int(short.group(1))]
                    if short else mangled)
            arg = re.search(r"SrcE(\d)E(?:Lb(\d))?", mangled)
            flags = re.search(r"I((?:Lb\dE)+)E", mangled)
            if arg and arg.group(2):
                vert = "true" if arg.group(2) == "1" else "false"
                name += f"<Src {arg.group(1)}, {vert}>"
            elif arg:
                name += f"<Src {arg.group(1)}>"
            elif flags:
                bools = re.findall(r"Lb(\d)E", flags.group(1))
                name += "<" + ", ".join(
                    "true" if d == "1" else "false" for d in bools) + ">"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            out[name] = f"{used}; {spill}"
            name = None
    return out


def sass_report(lib: Path, kernel: str = "recon_kernel") -> None:
    """Writes the SASS of `kernel` (cuobjdump -sass of the CUDA toolkit,
    where it is installed) beside the library as <kernel>.sass, and prints
    its instruction count by opcode."""
    import collections
    import re

    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        print(f"  SASS of {kernel}: no cuobjdump at {tool}", flush=True)
        return
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True)
    body, inside = [], False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            body.append(line.strip())
    (lib.parent / f"{kernel}.sass").write_text("\n".join(body) + "\n")
    instrs = [re.sub(r"^@!?U?P\w+\s+", "", line.split("*/", 1)[1].split(";")[0]
                     .strip()) for line in body]
    ops = collections.Counter(i.split()[0] for i in instrs)
    print(f"  SASS of {kernel}: {len(body)} instructions "
          f"({lib.parent / f'{kernel}.sass'}); by opcode: "
          + json.dumps(dict(ops.most_common())), flush=True)
    steps = list(walk_chains(instrs))
    chains = collections.Counter(chain for chain, _ in steps)
    print(f"  SASS of {kernel}, the walk's steps (from the x_(t-1) that one "
          "LEA.HI by 16 writes to the next one's x_t, straight-line code): "
          + (json.dumps({" -> ".join(c): k for c, k in chains.items()})
             if chains else "no such step found")
          + (f"; {sum(len(ops) for _, ops in steps) / len(steps):.2f} "
             "instructions a step, " + json.dumps(dict(collections.Counter(
                 op for _, ops in steps for op in ops).most_common(8)))
             if steps else ""), flush=True)


def walk_chains(instrs):
    """The dependent instructions from x_(t-1) to x_t of each step of R's
    walk that lies in straight-line SASS: a step ends in the LEA.HI that
    shifts the accumulator by 16 and adds the residual; the chain is the
    longest path of register and carry-predicate dependences from one such
    LEA.HI to the next. Yields (the chain's opcodes, the opcodes of every
    instruction from the one LEA.HI to the next)."""
    import re

    def reg_span(r, n):  # r and the n - 1 registers after it
        return [r] + ([f"R{int(r[1:]) + k}" for k in range(1, n)]
                      if re.fullmatch(r"R\d+", r) else [])

    defs, reads = {}, []
    for i, ins in enumerate(instrs):
        op, _, rest = ins.partition(" ")
        regs = [a.strip().lstrip("-!|").split(".")[0]
                for a in rest.split(",") if a.strip()]
        out, src = regs[:1], regs[1:]
        if op.startswith(("ST", "BAR", "BRA", "EXIT")):
            out, src = [], regs  # no register result
        if op.startswith(("IADD3", "LOP3", "ISETP", "PLOP3")) and ".X" not in op:
            while src and re.fullmatch(r"P\d", src[0]):
                out.append(src.pop(0))  # carry or predicate outputs
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
        if out:
            out = reg_span(out[0], width) + out[1:]
        if ".WIDE" in op and len(src) >= 3:  # the 64-bit addend
            src = src[:2] + reg_span(src[2], 2)
        reads.append({defs[r] for r in src if r in defs})
        for r in out:
            defs[r] = i
    ends = [i for i, ins in enumerate(instrs)
            if ins.startswith("LEA.HI ") and ins.rstrip().endswith("0x10")]
    for a, b in zip(ends, ends[1:]):
        best = {a: []}  # instruction -> longest chain from a to it
        for i in range(a + 1, b + 1):
            prev = [best[j] for j in reads[i] if j in best]
            if prev:
                best[i] = max(prev, key=len) + [instrs[i].split()[0]]
        if b in best:
            yield (tuple(best[b]),
                   [ins.split()[0] for ins in instrs[a + 1:b + 1]])


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    if not (ROOT / "dctpu_torch").is_dir():
        fail(f"dctpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.dist import make_mesh
    from dctpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({lib.parent.name})")
    ptxas = ptxas_report((lib.parent / "build.log").read_text())
    for name, info in ptxas.items():
        print(f"  ptxas: {name}: {info}")
    sass_report(lib)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    print("kernels vs plain twins (tolerance: exact, max_abs_err 0):",
          flush=True)
    recs = check_kernels(dev)

    streams, ids, cads = synth_corpus(**CORPUS)
    frames, by_path, enc_s = {}, {}, {}
    for coder in CODERS:
        frames[coder], by_path[coder], enc_s[coder] = run_path(
            dev, coder, streams, ids, cads)
    one_range_check(dev)
    by_path["adaptive/reduce-select"] = reduce_select_check(dev, streams)
    for coder in ("vertical", "rice"):
        by_path[f"{coder}/z-form-emit"] = zform_emit_check(dev, streams, coder)
    for coder in ("adaptive", "vertical"):
        data, by_path[path_name(coder, "pallas")], _ = run_path(
            dev, coder, streams, ids, cads, backend="pallas")
        if data != frames[coder]:
            fail(f"the {coder} frame under backend='pallas' differs from the "
                 "default frame")
        print(f"{coder}/pallas frame byte-identical to the {coder} frame",
              flush=True)
    for coder in CODERS:
        by_path[f"{coder}/sharded"] = run_sharded(
            coder, streams, ids, cads, make_mesh(), 2048, frames[coder])
    by_path["adaptive/sharded-2x4"] = run_sharded(
        "adaptive", streams, ids, cads, [dev, dev], 2048, frames["adaptive"])
    by_path.update(multihost_check(frames, CORPUS))
    aux_check(dev, streams, ids, cads, frames, enc_s)
    flat_feed_check(dev, streams)
    # the count of the path each kernel was ported for: K1-K4 and R the
    # adaptive path, K5a, K5b and K6's forms the rice path, VC's forms the
    # vertical path, K7 the "reduce"
    # selection, K3's and K5a's z forms the z-form emissions, K8 and K9 the
    # adaptive path under backend="pallas"
    home = {"K5a": "rice", "K5b": "rice", "K6": "rice", "K6-xbp": "rice",
            "K6-lpc": "rice", "K3-z": "vertical/z-form-emit",
            "K5a-z": "rice/z-form-emit",
            "K7": "adaptive/reduce-select", "K8": "adaptive/pallas",
            "K9": "adaptive/pallas", "VC-xbp": "vertical",
            "VC-lpc": "vertical"}
    for key, r in recs.items():
        r["launches"] = by_path[home.get(key, "adaptive")][key]
        r["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
    print("K5b, K4 and K5a's x form on the frames' coder groups:", flush=True)
    group_times(dev, frames, recs, streams)
    oracle_check(streams, ids, cads, frames)
    cli_check()

    print(json.dumps({"kernels": list(recs.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        multihost_worker(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
