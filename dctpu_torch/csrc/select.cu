// K1, K2, K6 and K7: exact selection totals (FORMAT §4, §4.1) per block.
// K7 (select_reduce_kernel, below) has its own design, described there.
//
// Replaces dctpu/kernels/select_bp.py _xbp_kernel (K1: DELTA and
// DOUBLE_DELTA candidates derived from raw samples) and _bp_kernel (K2: one
// candidate's zigzag values), and dctpu/kernels/select_pallas.py
// _totals_kernel (K6: K2's RICE half alone, for the coder="rice" k
// choice). For each candidate and block the output row holds the exact RICE
// coded-bit total for every k in [0, k_max] and, last (K1 and K2 only), the
// exact VERTICAL word count (the width rule summed over the block's
// sub-block rows). The three share one kernel template: VERT switches the
// VERTICAL word count on.
//
// What bounds it on the card: one read of the block (16 KiB at
// block_len 4096) against ~4 integer ops per sample and k for the RICE
// totals, and 32 warp votes per row and candidate for the exceed table.
// It is compute-bound, not memory-bound (K6 as well: ~4 ops per sample
// and k against one 4-byte read per sample). Design: one thread block of 128
// threads per codec block walks the block's rows, so a block's totals are
// reduced inside the thread block (no atomics, no second pass). The RICE
// totals are summed per sample from the definition
// L(k) = sum_t (q_t < 16 ? q_t + 1 + k : 48) -- the same integers as the TPU
// kernel's plane identity -- in registers, and reduced once per block.
#include "bitplane.cuh"

namespace dct {

template <int NC, bool FROM_X, bool VERT>
__global__ void __launch_bounds__(kSub)
select_totals_kernel(const int32_t* __restrict__ src,
                     const int32_t* __restrict__ hist,
                     const int32_t* __restrict__ n,
                     int32_t* __restrict__ out, int block_len, int k_max) {
  __shared__ int part[kWarps][32];
  __shared__ int e_sh[32];
  __shared__ int red[kWarps][NC][kMaxK];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = min(n[blk], block_len);
  const int32_t* row = src + static_cast<size_t>(blk) * block_len;
  int32_t h0 = 0, h1 = 0;
  if constexpr (FROM_X) {
    h0 = hist[blk * 4 + 0];
    h1 = hist[blk * 4 + 1];
  }

  int acc[NC][kMaxK];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[c][k] = 0;
  int vwords[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) vwords[c] = 0;

  const int subs = (block_len + kSub - 1) / kSub;
  for (int s = 0; s < subs; ++s) {
    const int i = s * kSub + tid;
    const bool valid = i < nb;
    uint32_t z[NC];
    if constexpr (FROM_X) {
      z[0] = 0;
      z[1] = 0;
      if (valid) {
        // wrapping int32 residuals, as predict.residuals_for_candidate
        const uint32_t x0 = static_cast<uint32_t>(row[i]);
        const uint32_t x1 = static_cast<uint32_t>(i >= 1 ? row[i - 1] : h0);
        const uint32_t x2 = static_cast<uint32_t>(
            i >= 2 ? row[i - 2] : (i == 1 ? h0 : h1));
        const uint32_t d = x0 - x1;
        z[0] = zigzag(static_cast<int32_t>(d));
        z[1] = zigzag(static_cast<int32_t>(d - (x1 - x2)));
      }
    } else {
      z[0] = valid ? static_cast<uint32_t>(row[i]) : 0u;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (valid) {
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k <= k_max) {
            const uint32_t q = z[c] >> k;
            acc[c][k] += q >= 16u ? 48 : static_cast<int>(q) + 1 + k;
          }
        }
      }
      if constexpr (VERT) {
        exceed_table(bit_length(z[c]), part, e_sh);
        if (warp == 0)
          vwords[c] += select_width(e_sh, plane_words(s, block_len)).words;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int v = __reduce_add_sync(kFull, acc[c][k]);
      if (lane == 0) red[warp][c][k] = v;
    }
  __syncthreads();
  const int width = k_max + (VERT ? 2 : 1);
  int32_t* o = out + static_cast<size_t>(blk) * NC * width;
  if (tid < NC * (k_max + 1)) {
    const int c = tid / (k_max + 1);
    const int k = tid % (k_max + 1);
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][c][k];
    o[c * width + k] = t;
  }
  if (VERT && tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c * width + k_max + 1] = vwords[c];
  }
}

// K7: K2's outputs in the reduction formulation of
// dctpu/kernels/select_pallas.py _adaptive_kernel (adaptive_totals_pallas),
// the A/B twin the reference keeps beside K2. Per 128-sample sub-block row:
// the direct per-k lengths (z >> (k + 4) != 0 ? 48 : ((z >> k) & 15) + k + 1)
// over the valid samples, then the exceed table E[b] = #{bit length > b} as
// 32 warp sums and the FORMAT §2.2 width rule on it.
//
// What bounds it on the card: ~4 integer ops per sample and k against one
// 4-byte read per sample, like K2: operations. Design: one thread block of
// kReduceWarps warps per codec block; each warp takes every kReduceWarps-th
// sub-block row, lane c holding samples 32i + c (coalesced loads). The
// TPU's pair- and quad-packed lane sums (which only cut Mosaic lane
// reductions) become __reduce_add_sync: one per b for E, one per k at the
// end; the width rule is bitplane.cuh's select_width on the warp's E. The
// warps' totals meet once in shared memory: no atomics, no second pass.
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(kReduceWarps * 32)
select_reduce_kernel(const int32_t* __restrict__ z,
                     const int32_t* __restrict__ n,
                     int32_t* __restrict__ out, int block_len, int k_max) {
  __shared__ int e_sh[kReduceWarps][32];
  __shared__ int red[kReduceWarps][kMaxK + 1];  // per-k sums, then vwords

  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = min(n[blk], block_len);
  const int32_t* row = z + static_cast<size_t>(blk) * block_len;

  int acc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) acc[k] = 0;
  int vwords = 0;

  const int subs = (block_len + kSub - 1) / kSub;
  for (int s = warp; s < subs; s += kReduceWarps) {
    uint32_t v[kWarps];
    int bl[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int idx = s * kSub + 32 * i + lane;
      const bool valid = idx < nb;
      v[i] = valid ? static_cast<uint32_t>(row[idx]) : 0u;
      bl[i] = bit_length(v[i]);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (valid && k <= k_max) {
          acc[k] += (v[i] >> (k + 4)) != 0u
                        ? 48
                        : static_cast<int>((v[i] >> k) & 15u) + k + 1;
        }
      }
    }
    int mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) c += bl[i] > b;
      c = __reduce_add_sync(kFull, c);
      if (lane == b) mine = c;
    }
    e_sh[warp][lane] = mine;
    __syncwarp();
    vwords += select_width(e_sh[warp], plane_words(s, block_len)).words;
    __syncwarp();  // e_sh is rewritten by the next row
  }

#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const int t = __reduce_add_sync(kFull, acc[k]);
    if (lane == 0) red[warp][k] = t;
  }
  if (lane == 0) red[warp][kMaxK] = vwords;
  __syncthreads();
  const int width = k_max + 2;
  if (threadIdx.x < width) {
    const int j = threadIdx.x <= k_max ? threadIdx.x : kMaxK;
    int t = 0;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) t += red[w][j];
    out[static_cast<size_t>(blk) * width + threadIdx.x] = t;
  }
}

}  // namespace dct

// K1: x [B, L] raw int32 samples, hist [B, 4] -> out [B, 2, k_max + 2]
// (candidate order DELTA, DOUBLE_DELTA).
extern "C" int dct_select_xbp(const void* x, const void* hist, const void* n,
                              void* out, int num_blocks, int block_len,
                              int k_max, void* stream) {
  dct::select_totals_kernel<2, true, true>
      <<<num_blocks, dct::kSub, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(x), static_cast<const int32_t*>(hist),
          static_cast<const int32_t*>(n), static_cast<int32_t*>(out),
          block_len, k_max);
  return static_cast<int>(cudaGetLastError());
}

// K2: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 2].
extern "C" int dct_select_bp(const void* z, const void* n, void* out,
                             int num_blocks, int block_len, int k_max,
                             void* stream) {
  dct::select_totals_kernel<1, false, true>
      <<<num_blocks, dct::kSub, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(z), nullptr,
          static_cast<const int32_t*>(n), static_cast<int32_t*>(out),
          block_len, k_max);
  return static_cast<int>(cudaGetLastError());
}

// K7: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 2],
// K2's layout.
extern "C" int dct_select_reduce(const void* z, const void* n, void* out,
                                 int num_blocks, int block_len, int k_max,
                                 void* stream) {
  dct::select_reduce_kernel<<<num_blocks, dct::kReduceWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(n),
      static_cast<int32_t*>(out), block_len, k_max);
  return static_cast<int>(cudaGetLastError());
}

// K6: z [B, L] zigzag values (int32 bit patterns) -> out [B, k_max + 1].
extern "C" int dct_rice_totals(const void* z, const void* n, void* out,
                               int num_blocks, int block_len, int k_max,
                               void* stream) {
  dct::select_totals_kernel<1, false, false>
      <<<num_blocks, dct::kSub, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(z), nullptr,
          static_cast<const int32_t*>(n), static_cast<int32_t*>(out),
          block_len, k_max);
  return static_cast<int>(cudaGetLastError());
}
