// K1, K2, K6 and K7: exact selection totals (FORMAT §4, §4.1), per block
// and candidate: the RICE coded-bit total for every k in [0, k_max] and,
// for the adaptive selection (VERT), the exact VERTICAL word count (the
// width rule summed over the block's 128-sample rows). All of them launch
// one template, select_lengths_kernel<Src, VERT>.
//
// Replaces dctpu/kernels/select_bp.py _xbp_kernel (K1: DELTA and
// DOUBLE_DELTA derived from the raw samples) and _bp_kernel (K2: one
// candidate's zigzag values), and dctpu/kernels/select_pallas.py
// _totals_kernel (K6: the RICE totals alone, for coder="rice") and
// _adaptive_kernel (K7: K2's function in a per-k reduction formulation that
// only cut Mosaic's lane reductions, kept by the reference as
// backend="reduce"; here it is K2's code). K2 has a form that derives one
// LPC candidate's residuals from the raw samples in the kernel, K6 one for
// DELTA + DOUBLE_DELTA and one for LPC; the TPU kernels left LPC to XLA,
// because s64 was wrong in Mosaic. The file also holds VC, the
// coder="vertical" selection cost, a lean kernel of its own beside the
// template (below it) that shares the row staging and the residuals.
//
// The arithmetic. With bl the bit length of z, C[b] = #{samples with bl =
// b} and S_j[b] = #{samples with bl = b whose bit b-1-j is set} (j = 1..3,
// the three bits below the leading one), for every k
//   L(k) = sum_t (z>>k < 16 ? (z>>k) + 1 + k : 48)
//        = 48 G + (k+1) (n - G)
//          + sum_{d=1..4} (2^(d-1) C[k+d] + sum_{j=1..d-1} 2^(d-1-j) S_j[k+d])
// with G = #{bl > k+4}: z>>k < 16 exactly when bl <= k+4, and for
// bl = k+d, z>>k is the leading one and the d-1 bits below it. The
// VERTICAL exceed table of a row, E[b] = #{bl > b}, is the suffix sum of
// the row's C. One histogram per row and candidate (four counters per bit
// length) gives both; the per-k work leaves the sample loop for the
// block's epilogue.
//
// What bounds it on the card: one read of the block (16 KiB at block_len
// 4096) against ~9 integer ops per sample and candidate (bit length, the
// three bits, four counts; the x forms add the residual) and, with VERT,
// ~330 per row for the width rule: bytes, by the count of chip_smoke.py
// work(). Design: a thread block of kRowWarps warps per codec block; warp w
// takes rows w, w + kRowWarps, ..., lane c holding samples 32i + c
// (coalesced loads); rows past n are skipped (they add nothing). Per
// sample one atomicAdd into the warp's shared row histogram, the four
// counters packed as the bytes of one word (a row adds at most 128 to a
// counter, so no field carries into the next); z = 0 is not counted (C[0]
// is n less the rest). Per row, lane b takes bin b+1 into the block's
// counters in registers and, with VERT, forms E[b] by a 5-step shuffle
// suffix scan and runs bitplane.cuh's select_width on it: no block barrier
// inside the row loop. The x forms stage each row and its four preceding
// samples (or the history) in the warp's shared memory, so that lag m is a
// shifted read, and take the residuals from residual.cuh (the LPC
// accumulator wraps as uint64_t, then takes an arithmetic >> 16 as
// int64_t), the code that vemit.cu's x form runs too. Epilogue: one
// __syncthreads, then warp c sums the warps' counters and lane k forms L(k)
// from the identity with shuffles. No atomics across thread blocks, no
// second pass.
#include "bitplane.cuh"
#include "residual.cuh"

namespace dct {

constexpr int kRowWarps = 4;

// The source of the candidates' zigzag values.
enum class Src { kZigzag, kDeltas, kLpc };

// Histogram increment of a nonzero z with lz = __clz(z): 1 in byte 0 (C),
// bits b-2, b-3, b-4 of z in bytes 1..3 (S_1..S_3). After z << lz the
// leading one is bit 31 and the three bits t follow it; the multiply
// places copies of t at bits 6, 15 and 24, which do not overlap.
__device__ __forceinline__ uint32_t length_inc(uint32_t z, int lz) {
  const uint32_t t = ((z << lz) >> 28) & 7u;
  return ((t * 0x01008040u) & 0x01010100u) | 1u;
}

// out [B, NC, k_max + 1 + VERT]: the RICE totals of each candidate, then
// (VERT) its VERTICAL word count.
template <Src SRC, bool VERT>
__global__ void __launch_bounds__(kRowWarps * 32)
select_lengths_kernel(const int32_t* __restrict__ src,
                      const int32_t* __restrict__ hist,
                      const int32_t* __restrict__ n,
                      int32_t* __restrict__ out, int block_len, int k_max,
                      Lpc lpc) {
  constexpr int NC = SRC == Src::kDeltas ? 2 : 1;
  constexpr bool FROM_X = SRC != Src::kZigzag;
  __shared__ uint32_t bins[kRowWarps][NC][32];  // the row's, bl = b at b-1
  __shared__ int32_t stage[kRowWarps][FROM_X ? 4 + kSub : 1];
  __shared__ int red[kRowWarps][NC][4][32];     // block counters per warp
  __shared__ int vred[kRowWarps][VERT ? NC : 1];

  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = max(0, min(n[blk], block_len));
  const int32_t* row = src + static_cast<size_t>(blk) * block_len;

  int cnt[NC][4];  // bin lane+1 of the block: C, S_1, S_2, S_3
  int vwords[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    bins[warp][c][lane] = 0;
    vwords[c] = 0;
#pragma unroll
    for (int f = 0; f < 4; ++f) cnt[c][f] = 0;
  }
  __syncwarp();

  const int rows = (nb + kSub - 1) / kSub;
  for (int s = warp; s < rows; s += kRowWarps) {
    const int base = s * kSub;
    uint32_t z[NC][kWarps];
    if constexpr (SRC == Src::kZigzag) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int t = base + 32 * i + lane;
        z[0][i] = t < nb ? static_cast<uint32_t>(row[t]) : 0u;
      }
    } else {
      int32_t* st = stage[warp];
      stage_row(st, row, hist + blk * 4, base, nb);
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int j = 4 + 32 * i + lane;
        const bool valid = base + 32 * i + lane < nb;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int pred = SRC == Src::kLpc ? kLpc : c;  // kDeltas: c = 0, 1
          const uint32_t r = residual(pred, lpc, st, j);
          z[c][i] = valid ? zigzag(static_cast<int32_t>(r)) : 0u;
        }
      }
    }

#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const uint32_t v = z[c][i];
        if (v) {
          const int lz = __clz(static_cast<int>(v));
          atomicAdd(&bins[warp][c][31 - lz], length_inc(v, lz));
        }
      }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t v = bins[warp][c][lane];
      bins[warp][c][lane] = 0;
      const int here = static_cast<int>(v & 0xffu);
      cnt[c][0] += here;
      cnt[c][1] += static_cast<int>((v >> 8) & 0xffu);
      cnt[c][2] += static_cast<int>((v >> 16) & 0xffu);
      cnt[c][3] += static_cast<int>(v >> 24);
      if constexpr (VERT)
        vwords[c] +=
            select_width(suffix_sum(here), plane_words(s, block_len)).words;
    }
    __syncwarp();  // bins and stage are rewritten by the next row
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int f = 0; f < 4; ++f) red[warp][c][f][lane] = cnt[c][f];
    if constexpr (VERT) {
      if (lane == 0) vred[warp][c] = vwords[c];
    }
  }
  __syncthreads();
  if (warp < NC) {
    const int c = warp;
    int C = 0, S1 = 0, S2 = 0, S3 = 0, vw = 0;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      C += red[w][c][0][lane];
      S1 += red[w][c][1][lane];
      S2 += red[w][c][2][lane];
      S3 += red[w][c][3][lane];
      if constexpr (VERT) vw += vred[w][c];
    }
    // lane k: bin k+d is d-1 lanes up; G = E[k+4]
    const int k = lane;
    const int G = bin_above(suffix_sum(C), 4);
    const int t = 48 * G + (k + 1) * (nb - G)
                + C + 2 * bin_above(C, 1) + 4 * bin_above(C, 2)
                + 8 * bin_above(C, 3)
                + bin_above(S1, 1) + 2 * bin_above(S1, 2)
                + 4 * bin_above(S1, 3)
                + bin_above(S2, 2) + 2 * bin_above(S2, 3)
                + bin_above(S3, 3);
    int32_t* o = out + (static_cast<size_t>(blk) * NC + c) * (k_max + 1 + VERT);
    if (k <= k_max) o[k] = t;
    if constexpr (VERT) {
      if (lane == 0) o[k_max + 1] = vw;
    }
  }
}

// VC: the coder="vertical" selection cost (FORMAT §2.2), out [B, NC]: per
// block and candidate, the sum of the bit lengths of its valid zigzag
// residuals, Σ_b b·C[b]. Replaces no Pallas kernel: the reference computes
// it in XLA (dctpu/kernels/vertical_xla.py vertical_selection_cost, over
// dctpu/codec/encode.py _cand_z_fn). The cost needs no histogram: each
// lane adds its samples' bit lengths in a register, so the template's
// shared atomics, per-row bins and per-k epilogue drop out. The rows go as
// in the template (warp w takes rows w, w + kRowWarps, ...; the residuals
// from the staged row); then a shuffle sum per warp and one __syncthreads
// to add the warps. Bound by the one read of x (~3 ops per sample and
// candidate besides the residual). The sum is at most 32 * block_len,
// which the wrapper keeps under 2^31.
template <Src SRC>
__global__ void __launch_bounds__(kRowWarps * 32)
vertical_cost_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ hist,
                     const int32_t* __restrict__ n,
                     int32_t* __restrict__ out, int block_len, Lpc lpc) {
  static_assert(SRC != Src::kZigzag, "VC derives the residuals from x");
  constexpr int NC = SRC == Src::kDeltas ? 2 : 1;
  __shared__ int32_t stage[kRowWarps][4 + kSub];
  __shared__ int red[kRowWarps][NC];

  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = max(0, min(n[blk], block_len));
  const int32_t* row = x + static_cast<size_t>(blk) * block_len;

  int cost[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) cost[c] = 0;

  const int rows = (nb + kSub - 1) / kSub;
  for (int s = warp; s < rows; s += kRowWarps) {
    const int base = s * kSub;
    int32_t* st = stage[warp];
    stage_row(st, row, hist + blk * 4, base, nb);
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int j = 4 + 32 * i + lane;
      const bool valid = base + 32 * i + lane < nb;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int pred = SRC == Src::kLpc ? kLpc : c;  // kDeltas: c = 0, 1
        const uint32_t r = residual(pred, lpc, st, j);
        cost[c] += valid ? bit_length(zigzag(static_cast<int32_t>(r))) : 0;
      }
    }
    __syncwarp();  // stage is rewritten by the next row
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int v = cost[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) v += red[w][threadIdx.x];
    out[static_cast<size_t>(blk) * NC + threadIdx.x] = v;
  }
}

template <Src SRC>
int launch_cost(const void* x, const void* hist, const void* n, void* out,
                int num_blocks, int block_len, Lpc lpc, void* stream) {
  vertical_cost_kernel<SRC>
      <<<num_blocks, kRowWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(x), static_cast<const int32_t*>(hist),
          static_cast<const int32_t*>(n), static_cast<int32_t*>(out),
          block_len, lpc);
  return static_cast<int>(cudaGetLastError());
}

template <Src SRC, bool VERT>
int launch(const void* src, const void* hist, const void* n, void* out,
           int num_blocks, int block_len, int k_max, Lpc lpc, void* stream) {
  select_lengths_kernel<SRC, VERT>
      <<<num_blocks, kRowWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(src), static_cast<const int32_t*>(hist),
          static_cast<const int32_t*>(n), static_cast<int32_t*>(out),
          block_len, k_max, lpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct

using dct::Lpc;
using dct::Src;

// K1: x [B, L] raw int32 samples, hist [B, 4] -> out [B, 2, k_max + 2]
// (candidate order DELTA, DOUBLE_DELTA).
extern "C" int dct_select_xbp(const void* x, const void* hist, const void* n,
                              void* out, int num_blocks, int block_len,
                              int k_max, void* stream) {
  return dct::launch<Src::kDeltas, true>(x, hist, n, out, num_blocks,
                                         block_len, k_max, Lpc{}, stream);
}

// K2: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 2].
extern "C" int dct_select_bp(const void* z, const void* n, void* out,
                             int num_blocks, int block_len, int k_max,
                             void* stream) {
  return dct::launch<Src::kZigzag, true>(z, nullptr, n, out, num_blocks,
                                         block_len, k_max, Lpc{}, stream);
}

// K2, LPC form: x [B, L] raw int32 samples, hist [B, 4] and one table's
// Q16 coefficients c0..c3 -> out [B, k_max + 2] of that LPC candidate.
extern "C" int dct_select_lpc(const void* x, const void* hist, const void* n,
                              void* out, int num_blocks, int block_len,
                              int k_max, int c0, int c1, int c2, int c3,
                              void* stream) {
  return dct::launch<Src::kLpc, true>(x, hist, n, out, num_blocks, block_len,
                                      k_max, Lpc{c0, c1, c2, c3}, stream);
}

// K7: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 2],
// K2's layout and K2's code.
extern "C" int dct_select_reduce(const void* z, const void* n, void* out,
                                 int num_blocks, int block_len, int k_max,
                                 void* stream) {
  return dct::launch<Src::kZigzag, true>(z, nullptr, n, out, num_blocks,
                                         block_len, k_max, Lpc{}, stream);
}

// K6: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 1].
extern "C" int dct_rice_totals(const void* z, const void* n, void* out,
                               int num_blocks, int block_len, int k_max,
                               void* stream) {
  return dct::launch<Src::kZigzag, false>(z, nullptr, n, out, num_blocks,
                                          block_len, k_max, Lpc{}, stream);
}

// K6, DELTA + DOUBLE_DELTA form: x [B, L] raw int32 samples, hist [B, 4]
// -> out [B, 2, k_max + 1] (candidate order DELTA, DOUBLE_DELTA).
extern "C" int dct_rice_totals_xbp(const void* x, const void* hist,
                                   const void* n, void* out, int num_blocks,
                                   int block_len, int k_max, void* stream) {
  return dct::launch<Src::kDeltas, false>(x, hist, n, out, num_blocks,
                                          block_len, k_max, Lpc{}, stream);
}

// K6, LPC form: x [B, L] raw int32 samples, hist [B, 4] and one table's Q16
// coefficients c0..c3 -> out [B, k_max + 1] of that LPC candidate.
extern "C" int dct_rice_totals_lpc(const void* x, const void* hist,
                                   const void* n, void* out, int num_blocks,
                                   int block_len, int k_max, int c0, int c1,
                                   int c2, int c3, void* stream) {
  return dct::launch<Src::kLpc, false>(x, hist, n, out, num_blocks,
                                       block_len, k_max, Lpc{c0, c1, c2, c3},
                                       stream);
}

// VC, DELTA + DOUBLE_DELTA form: x [B, L] raw int32 samples, hist [B, 4] ->
// out [B, 2] int32, the sums of the bit lengths (candidate order DELTA,
// DOUBLE_DELTA).
extern "C" int dct_vertical_cost_xbp(const void* x, const void* hist,
                                     const void* n, void* out, int num_blocks,
                                     int block_len, void* stream) {
  return dct::launch_cost<Src::kDeltas>(x, hist, n, out, num_blocks,
                                        block_len, Lpc{}, stream);
}

// VC, LPC form: x [B, L] raw int32 samples, hist [B, 4] and one table's Q16
// coefficients c0..c3 -> out [B] int32, that LPC candidate's sums.
extern "C" int dct_vertical_cost_lpc(const void* x, const void* hist,
                                     const void* n, void* out, int num_blocks,
                                     int block_len, int c0, int c1, int c2,
                                     int c3, void* stream) {
  return dct::launch_cost<Src::kLpc>(x, hist, n, out, num_blocks, block_len,
                                     Lpc{c0, c1, c2, c3}, stream);
}
