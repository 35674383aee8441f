"""The bytes and integer operations each kernel of the port needs, and the
least time they take on the card: the yardstick of the kernels' roofline
shares.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``work``, ``pred_ops``,
their op constants and the peaks, in numpy, counted on the live data:
where ``chip_smoke.py`` charges whole padded blocks and rows (B x L
samples, every emission row at its full width), these count each block's
valid samples and the words its frame holds. The counts are those of the
function, the same for any implementation: each input byte it needs read
once, each output byte it needs written once, the integer work the
algorithm needs. The peaks are NVIDIA's data sheet's for the H100 SXM at
its full 700 W; the run records the card's power limit beside them.

``KERNELS`` names each ``__global__`` of ``dctpu_torch/csrc/*.cu`` as the
profiler shows it, with the template arguments that tell its forms apart,
and gives its key in ``work`` and the blocks one launch covers on the
frame paths.
"""

from __future__ import annotations

import re

import numpy as np

PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_OPS_S = 67e12      # float32 outside the tensor cores; int32 is no higher
K_MAX = 24
SUB = 128

LEN_OPS, K_OPS, ROW_OPS = 9, 24, 32 + 33 * 9
DELTAS_OPS, LPC_OPS = 3 + 2 * 3, 2 * (4 + 3 + 1) + 1 + 3
VC_OPS = 3
PRED_OPS = {0: 4, 1: 2 + 4, 2: 2 * (4 + 3 + 1) + 4}


def bound(nbytes: float, ops: float):
    """(least ms on the card, what bounds it) for this many bytes moved
    and integer ops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pred_ops(n, L, pred) -> int:
    """Prediction ops of each block's valid samples for its predictor."""
    v = np.clip(np.asarray(n, np.int64), 0, L)
    pred = np.asarray(pred)
    return sum(c * int(v[pred == p].sum()) for p, c in PRED_OPS.items())


def work(key, B, L, n, b, rows_words, preds):
    """(bytes, ops) of kernel `key` on B blocks of L samples with valid
    counts n, VERTICAL widths b (one per sub-block), the words of
    ``rows_words`` and the predictors ``preds`` of the blocks it derives
    residuals for (``chip_smoke.py``'s ``work`` on the valid samples and
    the live words)."""
    v = int(np.clip(np.asarray(n, np.int64), 0, L).sum())
    K1 = K_MAX + 1
    R = B * -(-L // 128)
    sub_bytes = R * 4
    rice = v * LEN_OPS + B * (33 + K_OPS * K1)
    select = rice + R * ROW_OPS
    rows_out = 4 * rows_words["K3"] + 8 * B
    return {
        "K1": (4 * v + 16 * B + 4 * B + 8 * B * (K1 + 1),
               2 * select + v * DELTAS_OPS),
        "K2": (4 * v + 4 * B + 4 * B * (K1 + 1), select),
        "K2-lpc": (4 * v + 16 * B + 4 * B + 4 * B * (K1 + 1),
                   select + v * LPC_OPS),
        "K3": (4 * v + 16 * B + 8 * B + 20 * rows_words["cands"] + rows_out,
               v * 64 + pred_ops(n, L, preds["K3"])),
        "K3-z": (4 * v + 4 * B + rows_out, v * 64),
        "R": (8 * v + 16 * B + 16 * B + 16 * rows_words["tables"],
              pred_ops(n, L, preds["R"])),
        "K4": (4 * rows_words["K4"] + 16 * B + 4 * B + 4 * v,
               3 * 128 * int(np.asarray(b).sum())),
        "K4-slot": (4 * rows_words["K4"] + 4 * B + 4 * B + 4 * v,
                    3 * 128 * int(np.asarray(b).sum())),
        "K5a": (4 * v + 16 * B + 12 * B + 20 * rows_words["cands"]
                + 4 * rows_words["K5a"] + 8 * B,
                20 * v + pred_ops(n, L, preds["K5a"])),
        "K5a-z": (4 * v + 8 * B + 4 * rows_words["K5a"] + 8 * B, 20 * v),
        "K5a-codes": (13 * v + 4 * rows_words["K5a"] + 8 * B, 20 * v),
        "K5b": (4 * rows_words["K5b"] + 12 * B + 8 * B + 4 * v, 20 * v),
        "K6": (4 * v + 4 * B + 4 * B * K1, rice),
        "K6-xbp": (4 * v + 16 * B + 4 * B + 8 * B * K1,
                   2 * rice + v * DELTAS_OPS),
        "K6-lpc": (4 * v + 16 * B + 4 * B + 4 * B * K1,
                   rice + v * LPC_OPS),
        "K7": (4 * v + 4 * B + 4 * B * (K1 + 1), select),
        "VC-xbp": (4 * v + 16 * B + 4 * B + 4 * B * 2,
                   v * (2 * VC_OPS + DELTAS_OPS)),
        "VC-lpc": (4 * v + 16 * B + 4 * B + 4 * B, v * (VC_OPS + LPC_OPS)),
        "K8": (sub_bytes * (128 + 1 + 4 + 16), 4 * 128 * R),
        "K9": (sub_bytes * 128 * 2, 15 * 128 * R),
        "CP": (8 * rows_words["CP"] + 24 * B + 4, 0),
        "CP-count": (32 * B + 8, 0),
    }[key]


# (profiler name, template arguments) -> (work key, the blocks one launch
# covers: "all", or the coder group "rice" or "vertical"). A template
# argument is its number (an enumerator's index) or true/false; "*" takes
# any value.
KERNELS = {
    ("select_lengths_kernel", ("1", "true")): ("K1", "all"),
    ("select_lengths_kernel", ("0", "true")): ("K2", "all"),
    ("select_lengths_kernel", ("2", "true")): ("K2-lpc", "all"),
    ("select_lengths_kernel", ("0", "false")): ("K6", "all"),
    ("select_lengths_kernel", ("1", "false")): ("K6-xbp", "all"),
    ("select_lengths_kernel", ("2", "false")): ("K6-lpc", "all"),
    ("vertical_cost_kernel", ("1",)): ("VC-xbp", "all"),
    ("vertical_cost_kernel", ("2",)): ("VC-lpc", "all"),
    ("rice_pack_kernel", ("0", "*")): ("K5a-z", "rice"),
    ("rice_pack_kernel", ("1", "*")): ("K5a", "rice"),
    ("rice_pack_kernel", ("2", "*")): ("K5a-codes", "rice"),
    ("vemit_rows_kernel", ("true",)): ("K3", "vertical"),
    ("vemit_rows_kernel", ("false",)): ("K3-z", "vertical"),
    ("vdec_words_kernel", ("false",)): ("K4", "vertical"),
    ("vdec_words_kernel", ("true",)): ("K4-slot", "vertical"),
    ("rice_unpack_words_kernel", ()): ("K5b", "rice"),
    ("recon_kernel", ()): ("R", "all"),
    ("count_range_kernel", ()): ("CP-count", "all"),
    ("compact_range_kernel", ()): ("CP", "all"),
    ("exc_extract_kernel", ()): ("K8", "vertical"),
    ("bit_planes_kernel", ()): ("K9", "vertical"),
}
BASES = {base for base, _ in KERNELS}
ENUMERATORS = {"kZigzag": "0", "kDeltas": "1", "kLpc": "2",
               "kZ": "0", "kX": "1", "kCodes": "2"}


def parse_name(name: str):
    """(base name, template arguments) of a kernel's name as the profiler
    gives it, e.g. ``void dct::select_lengths_kernel<(dct::Src)1, true>(int
    const*, ...)`` -> ("select_lengths_kernel", ("1", "true"))."""
    head = re.sub(r"^void\s+", "", name.strip())
    m = re.match(r"([\w:]+)\s*(<.*?>)?\s*(\(|$)", head)
    if not m:
        return head, ()
    base = m.group(1).split("::")[-1]
    args = []
    if m.group(2):
        for a in m.group(2)[1:-1].split(","):
            a = a.strip()
            word = re.sub(r"^\([\w:]+\)", "", a).split("::")[-1].rstrip("uUlL")
            args.append(ENUMERATORS.get(word, word))
    return base, tuple(args)


def classify(name: str):
    """(work key, group) of one of the port's kernels, ("?", None) for one
    of its kernels in a form the table lacks, None for any other kernel
    (PyTorch's own)."""
    base, args = parse_name(name)
    if base not in BASES:
        return None
    for (b, want), val in KERNELS.items():
        if b == base and len(want) == len(args) and all(
                w in ("*", a) for w, a in zip(want, args)):
            return val
    return ("?", None)


def frame_groups(blocks, cfg: dict) -> dict:
    """What each coder group of one encoded input holds, from the
    reference's blocks: per group its B, n, predictors, VERTICAL widths
    and the words of the ``work`` arguments: the group's words in the
    frame, which the emission writes (K3, K5a) and the decode reads (K4,
    K5b, CP)."""
    L = cfg["block_len"]
    S = -(-L // SUB)
    counts = np.diff(blocks.word_off)
    out = {}
    for group, sel in (("all", np.ones(blocks.coder.size, bool)),
                       ("rice", blocks.coder == 0), ("vertical", blocks.coder == 1)):
        idx = np.nonzero(sel)[0]
        widths = np.zeros((0, S), np.int64)
        if group == "vertical" and idx.size:
            s = np.arange(S)
            word = blocks.words[blocks.word_off[idx][:, None] + s // 2].astype(np.int64)
            widths = (word >> (16 * (s % 2))) & 0x3F
        words = int(counts[idx].sum())
        out[group] = {
            "B": int(idx.size), "n": blocks.n[idx].astype(np.int64),
            "pred": blocks.predictor[idx], "b": widths,
            "rows_words": {
                "K3": words, "K5a": words, "K4": words, "K5b": words, "CP": words,
                "cands": 2 + len(cfg["lpc_tables"]), "tables": len(cfg["lpc_tables"]),
            },
        }
    return out


def launch_bound_ms(key: str, group: dict, L: int) -> float:
    """Least ms of one launch of kernel `key` over one coder group."""
    if group["B"] == 0:
        return 0.0
    preds = {k: group["pred"] for k in ("K3", "K5a", "R")}
    nbytes, ops = work(key, group["B"], L, group["n"], group["b"],
                       group["rows_words"], preds)
    return bound(nbytes, ops)[0]
