#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dctpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

  1. prints the card (nvidia-smi name and power limit) and builds the CUDA
     kernels from dctpu_torch/csrc (one nvcc per source, in parallel);
  2. holds each kernel K1-K9 and R against its plain torch twin on the
     card, bit-exact, at 256 x 4096, 8192 x 4096, 256 x 200
     (block_len % 128 != 0) and 32 x 12000 (rows too large for K5a's
     shared-memory path), with edge rows, and times both at 8192 x 4096
     with CUDA events beside each kernel's bound; K2 in both its forms,
     on zigzag values and on the raw samples with an LPC table ("K2-lpc":
     each default table and one whose products wrap the int64
     accumulator), K6 in its three: on zigzag values, on the raw samples
     for DELTA + DOUBLE_DELTA ("K6-xbp") and for an LPC table ("K6-lpc",
     the same tables), K3 in its two, the payload rows from the raw
     samples with every candidate of those tables chosen ("K3") and from
     zigzag values ("K3-z"), K5a in its two, likewise ("K5a", the RICE
     rows from the raw samples at every k in 0..30, and "K5a-z"), K9's
     disk-order planes, R (the reconstruction) on every predictor and
     table, with histories at the int32 extremes, and the decode kernels
     K4 and K5b on the compact words of their blocks, laid out in a
     shuffled order between words of no block, a few RICE blocks cut
     short, and a bad VERTICAL sync entry that must raise;
  3. drives compress -> write_frame -> read_frame -> decompress for the
     adaptive, rice and vertical coders at the bench geometry (8192 blocks
     x 4096 int32 = 128 MiB, resident on the card), each with the launch
     counters set to 0 just before it and read just after: every round
     trip bit-exact, every kernel of each path launched (K6-xbp once,
     K6-lpc once per LPC candidate and K6's z form never on the rice path;
     K1 once and K2's LPC form once per LPC candidate on the adaptive
     paths; R once per coder group in every decode, K5b once per RICE
     group and K4 once per VERTICAL group; K3 once per VERTICAL group and
     its z form never; K5a's x form once per RICE group and its z form
     never), and the plain torch stages that R, K3, K4, K5a and K5b
     replace never run (the LPC recurrence loop, the region assembly, the
     winner's residuals in an emission, the staging of the decode's
     rows), with the device segments each compress obtained from
     the allocator (and, for the adaptive path, the stage times of a
     second compress on the cached segments); then, on the same corpus,
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
  4. builds the C++ oracle and checks, for each coder, that its frame of the
     same corpus is byte-identical to the port's and that it decodes the
     port's frame back to the input;
  5. runs the port's CLI (``python3 -m dctpu_torch.cli.main verify``) on the
     card as a subprocess;
  6. prints one JSON line of the kernels, then the result line.

Any failure exits non-zero. Without a CUDA device it fails; it never runs
on the CPU instead.
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
        "R": (8 * B * L + 16 * B + 12 * B + 16 * rows_words["tables"],
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
}


def recon_scaling(z, n, tidx, hist, coeffs) -> None:
    """R's time with every block on one predictor, at B and at B / 16
    blocks: a time that moves with neither is the per-warp chain of the
    walk, not device bandwidth and not the LPC arithmetic."""
    import torch

    from dctpu_torch.kernels.reconstruct import reconstruct

    for rows in (z.shape[0], z.shape[0] // 16):
        for pred in (0, 2):
            p = torch.full((rows,), pred, dtype=torch.int32, device=z.device)
            args = (z[:rows], n[:rows], p, tidx[:rows], hist[:rows], coeffs)
            ms = time_ms(lambda: reconstruct(*args), 10)  # noqa: B023
            print(f"  R {rows}x{z.shape[1]}, every block predictor {pred}: "
                  f"{ms:.4f} ms", flush=True)


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
    from dctpu_torch.kernels.reconstruct import reconstruct, reconstruct_plain
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

    recs = {
        key: dict(name=name, route="cuda", source=src, replaces=rep,
                  max_abs_err=0, library_ms=None)
        for key, (name, src, rep) in RECS.items()
    }
    K = K_MAX
    # K2-lpc and K6-lpc are held against their twins with every default
    # table and one whose products wrap the int64 accumulator on the
    # -2**31 samples of row 0; they are timed with the first default table.
    # K3 and K5a's x form choose every candidate of those tables in turn,
    # block by block, K5a at k = i % 31 on block i; R gives block i
    # predictor i % 3 and table i // 3 % T, so that block 14 runs the wrap
    # table, here on -2**31 samples (a -2**31 history and residuals,
    # z = 0xFFFFFFFF)
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
            "K8": (lambda: exc_extract(zs, b_exc),
                   lambda: exc_extract_plain(zs, b_exc)),
            "K9": (lambda: (bit_planes32(groups),),
                   lambda: (bit_planes32_plain(groups),)),
            "R": (lambda: (reconstruct(zr, n, pred_r, tidx, hist_r, coeffs),),
                  lambda: (reconstruct_plain(zr, n, pred_r, tidx, hist_r,
                                             coeffs),)),
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
                    recon_scaling(zr, n, tidx, hist_r, coeffs)
        del x, z, hist, n, k, rows, planes, vwords, pos_words, vals, payload
        del r_words, r_start, r_count, v_words, v_start, v_count
        del zs, b_exc, groups, emitted, choice, pred_r, tidx, hist_r, zr, preds
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
    ("vertical", None): ("K3", "K4", "R"),
    ("adaptive", "pallas"): ("K1", "K2", "K2-lpc", "K4", "K5a", "K5b", "K8",
                             "K9", "R"),
    ("vertical", "pallas"): ("K4", "K8", "K9", "R"),
}
NEVER = {
    ("adaptive", None): ("K3-z", "K5a-z", "K9"),
    ("rice", None): ("K5a-z",),
    ("vertical", None): ("K3-z", "K5a-z", "K9"),
    ("adaptive", "pallas"): ("K3", "K3-z", "K5a-z"),
    ("vertical", "pallas"): ("K3", "K3-z", "K5a-z"),
}


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the plain torch stages that R, K3, K4, K5a and
    K5b replace on the default paths: the LPC recurrence loop, the region
    assembly, the winner's residuals of an emission (a VERTICAL group's on
    the staged backends only), and the staging of the decode's VERTICAL
    and RICE rows; and the flips in the staged VERTICAL emission, which K9
    no longer needs."""
    import torch

    from dctpu_torch.codec import encode, predict
    from dctpu_torch.kernels import ragged, vemit

    counts = {"reconstruct_lpc": 0, "assemble_rows": 0, "chosen_residuals": 0,
              "stage_vertical": 0, "pad_payload": 0, "staged_flip": 0}
    patched = [(predict, "reconstruct_lpc"), (encode, "assemble_rows"),
               (vemit, "assemble_rows"), (predict, "chosen_residuals"),
               (ragged, "stage_vertical"), (ragged, "pad_payload")]
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


def segments() -> int:
    """Device memory segments the caching allocator has obtained so far
    (one cudaMalloc each)."""
    import torch

    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def path_name(coder, backend) -> str:
    return coder if backend is None else f"{coder}/{backend}"


def run_path(dev, coder, streams, ids, cads, backend=None):
    """Phase 3, one coder and backend: the 128 MiB round trip. Returns
    (frame bytes, launches per kernel)."""
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
    with plain_calls() as plain:
        t0 = time.perf_counter()
        frame = compress(streams, cfg, ids, cads, device=dev, stage_ms=enc_ms,
                         backend=backend)
        seg1 = segments()
        data = write_frame(frame)
        t1 = time.perf_counter()
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
    groups = int((hist > 0).sum())
    staged = backend is not None
    staged_vert = int(staged and hist[1] > 0)
    want_plain = {"reconstruct_lpc": 0, "assemble_rows": staged_vert,
                  "chosen_residuals": staged_vert, "stage_vertical": 0,
                  "pad_payload": 0, "staged_flip": 0}
    if (launches["R"], launches["K3"], plain) != (
            groups, 0 if staged else int(hist[1] > 0), want_plain):
        fail(f"R launched {launches['R']} times (want {groups}, one per coder "
             f"group), K3 {launches['K3']}, plain stages {plain} (want "
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
    if cfg.coder == "adaptive" and (launches["K1"], launches["K2-lpc"]) != (1, n_lpc):
        fail(f"K1 launched {launches['K1']} times (want 1), K2's LPC form "
             f"{launches['K2-lpc']} (want {n_lpc})")
    return data, launches


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
    """Phase 5: the port's CLI verifies a small DCR1 file on the card."""
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.format import write_raw

    streams, ids, cads = synth_corpus(4, 20000, seed=31, mixed_cadence=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "in.dcr"
        src.write_bytes(write_raw(streams, ids, cads))
        res = subprocess.run(
            [sys.executable, "-m", "dctpu_torch.cli.main", "verify", str(src),
             "--coder", "rice"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
    print(f"cli: verify --coder rice exit {res.returncode}: "
          f"{res.stderr.strip()[-200:]}", flush=True)
    if res.returncode != 0:
        fail("the CLI's verify failed on the card")


def ptxas_report(log: str) -> dict:
    """{kernel: "N registers, smem, spill"} from the nvcc -Xptxas=-v log;
    a dct::...<Src i, VERT> template shows as "name<Src i, true|false>",
    a dct::...<bool, ...> one as "name<true|false, ...>"."""
    import re

    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            short = re.match(r"_ZN3dct(\d+)", mangled)
            name = (mangled[short.end():short.end() + int(short.group(1))]
                    if short else mangled)
            arg = re.search(r"SrcE(\d)ELb(\d)", mangled)
            flags = re.search(r"I((?:Lb\dE)+)E", mangled)
            if arg:
                vert = "true" if arg.group(2) == "1" else "false"
                name += f"<Src {arg.group(1)}, {vert}>"
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
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    print("kernels vs plain twins (tolerance: exact, max_abs_err 0):",
          flush=True)
    recs = check_kernels(dev)

    streams, ids, cads = synth_corpus(
        16, BENCH_BLOCKS * BENCH_LEN // 16, seed=123, mixed_cadence=True,
        cumulative_frac=0.25,
    )
    frames, by_path = {}, {}
    for coder in CODERS:
        frames[coder], by_path[coder] = run_path(dev, coder, streams, ids, cads)
    by_path["adaptive/reduce-select"] = reduce_select_check(dev, streams)
    for coder in ("vertical", "rice"):
        by_path[f"{coder}/z-form-emit"] = zform_emit_check(dev, streams, coder)
    for coder in ("adaptive", "vertical"):
        data, by_path[path_name(coder, "pallas")] = run_path(
            dev, coder, streams, ids, cads, backend="pallas")
        if data != frames[coder]:
            fail(f"the {coder} frame under backend='pallas' differs from the "
                 "default frame")
        print(f"{coder}/pallas frame byte-identical to the {coder} frame",
              flush=True)
    # the count of the path each kernel was ported for: K1-K4 and R the
    # adaptive path, K5a, K5b and K6's forms the rice path, K7 the "reduce"
    # selection, K3's and K5a's z forms the z-form emissions, K8 and K9 the
    # adaptive path under backend="pallas"
    home = {"K5a": "rice", "K5b": "rice", "K6": "rice", "K6-xbp": "rice",
            "K6-lpc": "rice", "K3-z": "vertical/z-form-emit",
            "K5a-z": "rice/z-form-emit",
            "K7": "adaptive/reduce-select", "K8": "adaptive/pallas",
            "K9": "adaptive/pallas"}
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
    sys.exit(main())
