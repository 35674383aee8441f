"""CP's copy (dctpu_torch/csrc/compact.cu) timed against variants of its
source on the card, at the two shapes chip_smoke.py times CP at.

Each variant is compact.cu with a few lines replaced (VARIANTS below); all
are built by nvcc together, one process each, under build/cp_variants/.
Each is launched on the same inputs as chip_smoke.py's CP timing (the
8192 x 4096 blocks of both coders, and the 128 MiB adaptive range's coder
groups as the encode leaves them), checked against CP's plain twin, and
timed as chip_smoke.time_spread does: the median, min and max of 5
time_ms(., 10). One torch copy_ of as many words is timed beside them.

Run from the repository root, on a machine with a card and nvcc:

    python3 cp_variants.py            # every variant
    python3 cp_variants.py base grid_4 unroll_4+grid_4

The last line is one JSON object: per shape, its words, its bytes bound,
the copy_ yardstick and each variant's time, share of the bound, ptxas
line and whether its words equal the twin's.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_COPY_WORDS_16 = r'''
// Words [0, count) of src to dst, as whole 16-byte loads where src is
// 16-byte aligned (kUnroll / 4 a lane in flight), the tail word by word.
__device__ __forceinline__ void copy_words_16(const int32_t* __restrict__ src,
                                              int32_t* __restrict__ dst,
                                              int count, int lane) {
  if (reinterpret_cast<uintptr_t>(src) & 15) {
    copy_words(src, dst, count, lane);
    return;
  }
  constexpr int kQ = kUnroll / 4;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  const int quads = count >> 2;
  for (int q0 = 0; q0 < quads; q0 += kQ * 32) {
    int4 v[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int q = q0 + u * 32 + lane;
      v[u] = q < quads ? __ldcs(s4 + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int base = 4 * (q0 + u * 32);
      STORE_QUAD
    }
  }
  const int i = 4 * quads + lane;
  if (i < count) __stcs(dst + i, __ldcs(src + i));
}

// One pass's words'''

# each lane stores its own four words: the warp's 4-byte stores stride by
# 16 bytes
_STRIDED = r'''const int i = base + 4 * lane;
      if (i < 4 * quads) {
        __stcs(dst + i, v[u].x);
        __stcs(dst + i + 1, v[u].y);
        __stcs(dst + i + 2, v[u].z);
        __stcs(dst + i + 3, v[u].w);
      }'''

# the warp's 128 words regrouped by shuffles, so that each store is 32
# consecutive words
_SHUFFLED = r'''#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int from = 8 * c + (lane >> 2);
        const int x = __shfl_sync(kFull, v[u].x, from);
        const int y = __shfl_sync(kFull, v[u].y, from);
        const int z = __shfl_sync(kFull, v[u].z, from);
        const int w = __shfl_sync(kFull, v[u].w, from);
        const int k = lane & 3;
        const int i = base + 32 * c + lane;
        if (i < 4 * quads) __stcs(dst + i, k == 0 ? x : k == 1 ? y : k == 2 ? z : w);
      }'''

_RICE_COPY = ("    copy_words(row, dst, static_cast<int>(words), lane);\n"
              "    return 0;")
_RICE_COPY_16 = ("    copy_words_16(row, dst, static_cast<int>(words), lane);\n"
                 "    return 0;")


def _rice_16(store):
    return [("\n// One pass's words", _COPY_WORDS_16.replace("STORE_QUAD", store)),
            (_RICE_COPY, _RICE_COPY_16)]


def _grid(per_sm):
    """A grid of at most per_sm CTAs an SM, whose warps walk the blocks."""
    return [(
        "  const int ctas = (num_blocks + dct::kCompactWarps - 1) / "
        "dct::kCompactWarps;",
        f"""  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int need = (num_blocks + dct::kCompactWarps - 1) / dct::kCompactWarps;
  const int ctas = need < {per_sm} * sms ? need : {per_sm} * sms;""")]


_LOOP = """  int bad = 0;
  for (int blk = blockIdx.x * kCompactWarps + (threadIdx.x >> 5);
       blk < num_blocks; blk += gridDim.x * kCompactWarps) {
    bad |= compact_block(g, src, coder, wc, off, out, blk, subs, sw,
                         block_len, lane);
  }"""
_EARLY_RETURN = """  const int blk = blockIdx.x * kCompactWarps + (threadIdx.x >> 5);
  if (blk >= num_blocks) return;  // the whole warp
  const int bad = compact_block(g, src, coder, wc, off, out, blk, subs, sw,
                                block_len, lane);"""


# name -> [(text of compact.cu, its replacement)]; a name "a+b" on the
# command line applies both
VARIANTS = {
    "base": [],
    "unroll_4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    "unroll_16": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 16;")],
    "no_stream_hint": [
        ("v[u] = i < count ? __ldcs(src + i) : 0;",
         "v[u] = i < count ? __ldg(src + i) : 0;"),
        ("if (i < count) __stcs(dst + i, v[u]);", "if (i < count) dst[i] = v[u];"),
        ("v[u] = j < total ? __ldcs(src + s * kRegionPad + (j - at)) : 0;",
         "v[u] = j < total ? __ldg(src + s * kRegionPad + (j - at)) : 0;"),
        ("if (j < total) __stcs(dst + j, v[u]);", "if (j < total) dst[j] = v[u];"),
    ],
    "rice_16B_strided_stores": _rice_16(_STRIDED),
    "rice_16B_shuffled_stores": _rice_16(_SHUFFLED),
    "grid_1": _grid(1),
    "grid_2": _grid(2),
    "grid_4": _grid(4),
    # the same grid and body, the warps past num_blocks returning early
    # instead of skipping the loop
    "early_return": [(_LOOP, _EARLY_RETURN)],
    # not CP: a VERTICAL block copied as the prefix of its staged row, with
    # no scan and no search (its words differ from the twin's)
    "vertical_as_prefix": [(
        "  const int passes = (subs + 31) >> 5;\n  bool ok = true;",
        "  copy_words(row, dst, static_cast<int>(words), lane);\n  return 0;\n"
        "  const int passes = (subs + 31) >> 5;\n  bool ok = true;")],
}
DEFAULT = [*VARIANTS, "rice_16B_strided_stores+unroll_16",
           "rice_16B_shuffled_stores+unroll_16"]


def substitutions(name):
    """The (old, new) pairs of a variant name, "a+b" for both."""
    return [pair for part in name.split("+") for pair in VARIANTS[part]]


def build(names):
    """Each named variant's source written and compiled, all nvcc processes
    started together -> {name: (dct_compact_range, its ptxas line)}."""
    import chip_smoke as cs
    from dctpu_torch.kernels import _build

    text = (_build.CSRC / "compact.cu").read_text()
    out_root = ROOT / "build" / "cp_variants"
    procs = {}
    for name in names:
        src = text
        for old, new in substitutions(name):
            if old not in src:
                raise SystemExit(f"{name}: compact.cu no longer holds {old!r}")
            src = src.replace(old, new)
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "compact.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(d / "lib.so"), str(d / "compact.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        regs = cs.ptxas_report(log).get("compact_range_kernel", "?")
        fn = ctypes.CDLL(str(out_root / name / "lib.so")).dct_compact_range
        fn.argtypes = list(_build.SIGNATURES["dct_compact_range"])
        fn.restype = ctypes.c_int
        fns[name] = (fn, regs)
    return fns


def shapes(dev):
    """(label, (rows_a, rows_b, coder, bit_len, L)) of chip_smoke.py's two
    CP timings."""
    import torch

    import chip_smoke as cs
    from dctpu_torch.codec import api
    from dctpu_torch.config import CodecConfig
    from dctpu_torch.corpus import synth_corpus
    from dctpu_torch.kernels import rice_pack, vemit

    B, L = cs.BENCH_BLOCKS, cs.BENCH_LEN
    si = cs.SHAPES.index((B, L))
    _, z, _, n, k = (torch.from_numpy(a).to(dev)
                     for a in cs.kernel_inputs(B, L, 100 + si))
    rice = rice_pack.rice_pack(z, k, n, L)
    vert = vemit.vertical_emit_rows_z(z, n, L)
    yield "mixed groups", (*cs.compact_groups(*rice, *vert, 500 + si), L)
    del z, n, k, rice, vert
    streams, ids, cads = synth_corpus(**cs.CORPUS)
    kept, real = [], api.compact_range_flagged
    api.compact_range_flagged = lambda *a: (kept.append(a), real(*a))[1]
    try:
        api.compress(streams, CodecConfig(coder="adaptive"), ids, cads,
                     device=dev)
    finally:
        api.compact_range_flagged = real
    yield "adaptive range", kept[0]


def main(names) -> None:
    import torch

    import chip_smoke as cs
    from dctpu_torch.kernels import compact

    if not torch.cuda.is_available():
        raise SystemExit("cp_variants.py needs a CUDA device")
    unknown = [n for n in names
               if any(part not in VARIANTS for part in n.split("+"))]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0],
        flush=True)
    fns = build(names)
    result = {}
    for label, args in shapes(dev):
        rows_a, rows_b, coder, bit_len, L = args
        coder = coder.to(torch.int32).contiguous()
        wc, off, src, total = compact.count_range(coder, bit_len, L)
        total = int(total)
        want = compact.compact_range_plain(*args)[0]
        B = coder.numel()
        bound_ms, _ = cs.bound(8 * total + 24 * B + 4, 0)
        flat = torch.empty(2 * total, dtype=torch.int32, device=dev)
        copy_ = cs.time_spread(lambda: flat[:total].copy_(flat[total:]))  # noqa: B023
        rec = {"blocks": B, "words": total, "bound_ms": bound_ms,
               "copy_ms": copy_, "variants": {}}
        print(f"== {label}: {B} blocks, {total} words, bytes bound "
              f"{bound_ms:.5f} ms; one copy_ of as many words "
              f"{copy_['median']:.5f} ms", flush=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, (fn, regs) in fns.items():
            buf = torch.zeros(total + 1, dtype=torch.int32, device=dev)
            call = (lambda fn=fn, buf=buf: compact._build.check(fn(  # noqa: E731
                *compact._group(rows_a), *compact._group(rows_b),
                src.data_ptr(), coder.data_ptr(),
                wc.data_ptr(), off.data_ptr(), buf.data_ptr(),
                buf[-1:].data_ptr(), B, L, stream), name))
            call()
            torch.cuda.synchronize()
            same = bool(torch.equal(buf[:-1], want)) and int(buf[-1]) == 0
            t = cs.time_spread(call)
            rec["variants"][name] = {**t, "share_of_bound": bound_ms / t["median"],
                                     "ptxas": regs, "equal_to_twin": same}
            print(f"  {name}: median {t['median']:.5f} ms (min {t['min']:.5f}, "
                  f"max {t['max']:.5f}), {100 * bound_ms / t['median']:.1f} % of "
                  f"the bound, equal to the twin: {same}; ptxas {regs}",
                  flush=True)
        result[label] = rec
        del buf, flat, want
    print(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:] or DEFAULT)
