// Shared device code of the predictor stage (docs/FORMAT.md §3): the
// forward residuals that the selection kernels (select.cu) and the VERTICAL
// emit (vemit.cu) derive from the raw samples, and the Q16 prediction that
// the reconstruction (recon.cu) runs backwards. One copy, so that every
// kernel computes the residual of predict.residuals_for_candidate bit for
// bit.
//
// All sample arithmetic wraps in int32 (uint32_t here). The LPC accumulator
// is the wrapping int64 sum of the four exact int32 x int32 products, then
// an arithmetic >> 16, then a wrap to int32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dct {

// predictor ids (FORMAT §3)
constexpr int kDelta = 0;
constexpr int kDoubleDelta = 1;
constexpr int kLpc = 2;

struct Lpc {
  int c0, c1, c2, c3;  // Q16 coefficients, int32 as in the frame
};

__device__ __forceinline__ uint32_t zigzag(int32_t r) {
  return (static_cast<uint32_t>(r) << 1) ^ static_cast<uint32_t>(r >> 31);
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

// The Q16 prediction of x_t from x_{t-1} .. x_{t-4}, wrapped to int32.
__device__ __forceinline__ uint32_t lpc_predict(const Lpc& c, int32_t x1,
                                                int32_t x2, int32_t x3,
                                                int32_t x4) {
  // each product is exact in int64; the sum wraps mod 2^64
  const uint64_t acc = static_cast<uint64_t>(static_cast<int64_t>(c.c0) * x1) +
                       static_cast<uint64_t>(static_cast<int64_t>(c.c1) * x2) +
                       static_cast<uint64_t>(static_cast<int64_t>(c.c2) * x3) +
                       static_cast<uint64_t>(static_cast<int64_t>(c.c3) * x4);
  return static_cast<uint32_t>(static_cast<int64_t>(acc) >> 16);
}

// DELTA and DOUBLE_DELTA as Q16 tables. Their predictions, x_{t-1} and
// 2 x_{t-1} - x_{t-2}, come out of lpc_predict exactly (the products stay
// under 2^49, so nothing wraps before the shift and the shift drops only
// zeros), so one recurrence reconstructs every predictor.
__device__ __forceinline__ Lpc predictor_table(int pred, const Lpc& lpc) {
  if (pred == kDelta) return Lpc{1 << 16, 0, 0, 0};
  if (pred == kDoubleDelta) return Lpc{2 << 16, -(1 << 16), 0, 0};
  return lpc;
}

// The x-form emission kernels (vemit.cu, pack.cu) take the configuration's
// candidates as a [C, kCandWords] table: predictor, then Q16 c0..c3.
constexpr int kCandWords = 5;

// Block's chosen candidate from that table; the clamp only keeps a bad
// choice inside the table.
__device__ __forceinline__ void chosen_candidate(const int32_t* cands,
                                                 int num_cands, int choice,
                                                 int& pred, Lpc& lpc) {
  const int32_t* cd = cands + kCandWords * min(max(choice, 0), num_cands - 1);
  pred = cd[0];
  lpc = Lpc{cd[1], cd[2], cd[3], cd[4]};
}

// Stages one 128-sample row of a block and the four samples before it in
// the warp's shared memory: st[4 + j] = x_{base + j} (0 from nb on),
// st[4 - m] = x_{base - m}, which before the block is history[m - 1]. All
// 32 lanes call it; it ends with __syncwarp.
__device__ __forceinline__ void stage_row(int32_t* st, const int32_t* row,
                                          const int32_t* history, int base,
                                          int nb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = base + 32 * i + lane;
    st[4 + 32 * i + lane] = t < nb ? row[t] : 0;
  }
  if (lane < 4) {
    const int t = base - 4 + lane;
    st[lane] = t >= 0 ? row[t] : history[-1 - t];
  }
  __syncwarp();
}

// The wrapping int32 residual of st[j] (a staged row) for one predictor:
// DELTA, DOUBLE_DELTA, else LPC with the coefficients c.
__device__ __forceinline__ uint32_t residual(int pred, const Lpc& c,
                                             const int32_t* st, int j) {
  const uint32_t x0 = static_cast<uint32_t>(st[j]);
  const uint32_t x1 = static_cast<uint32_t>(st[j - 1]);
  if (pred == kDelta) return x0 - x1;
  const uint32_t x2 = static_cast<uint32_t>(st[j - 2]);
  if (pred == kDoubleDelta) return x0 - x1 - (x1 - x2);
  return x0 - lpc_predict(c, st[j - 1], st[j - 2], st[j - 3], st[j - 4]);
}

}  // namespace dct
