// K8: VERTICAL exception extraction at given widths.
//
// Replaces dctpu/kernels/vertical_pallas.py _encode_exc_kernel
// (exc_extract_pallas). For each 128-sample sub-block row (zero past its
// valid count) and its width b, the exceptions are the samples with
// z >> b != 0 (none when b >= 32), ranked in ascending position. Ranks
// below EXC_CAP = 16 give vals[rank] = z >> b and the position byte
// (lane << 8 * (rank & 3)) of word rank >> 2; higher ranks are dropped
// (b is an input, so a row may hold more than 16). Slots past the count
// are zero.
//
// What bounds it on the card: 512 bytes read and 80 bytes written per row
// with a few warp votes in between, so it is bound by memory traffic.
// Design: one warp per row; lane c holds samples 32i + c for i = 0..3
// (coalesced loads). The TPU kernel's Kogge-Stone lane prefix and its 20
// rank-match reductions become the ballot prefix of K3 (vemit.cu): the rank
// is the exceptions of the earlier 32-sample slices plus
// __popc(mask & lanemask_lt). The 16 values and positions go through a
// per-warp shared-memory slot, then lanes 0..15 store the values and lanes
// 0..3 pack the position words.
#include "bitplane.cuh"

namespace dct {

constexpr int kExcWarps = 8;  // rows per thread block

__global__ void __launch_bounds__(kExcWarps * 32)
exc_extract_kernel(const int32_t* __restrict__ zs, const int32_t* __restrict__ b,
                   int32_t* __restrict__ pos, int32_t* __restrict__ vals,
                   long long rows) {
  __shared__ uint32_t val_sh[kExcWarps][kExcCap];
  __shared__ uint32_t pos_sh[kExcWarps][kExcCap];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kExcWarps + warp;
  if (r >= rows) return;  // the whole warp
  const int32_t* zr = zs + r * kSub;
  // b as u32, as the reference casts it: b >= 32 gives no exceptions
  const uint32_t bw = static_cast<uint32_t>(b[r]);
  const uint32_t lt = (1u << lane) - 1u;

  int count = 0;  // exceptions in the slices before this one
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t v = static_cast<uint32_t>(zr[32 * i + lane]);
    const uint32_t high = bw >= 32u ? 0u : v >> bw;
    const uint32_t mask = __ballot_sync(kFull, high != 0u);
    const int rank = count + __popc(mask & lt);
    if (high != 0u && rank < kExcCap) {
      val_sh[warp][rank] = high;
      pos_sh[warp][rank] = 32 * i + lane;
    }
    count += __popc(mask);
  }
  __syncwarp();
  const int live = min(count, kExcCap);
  if (lane < kExcCap) {
    vals[r * kExcCap + lane] =
        static_cast<int32_t>(lane < live ? val_sh[warp][lane] : 0u);
  }
  if (lane < kExcCap / 4) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rank = 4 * lane + j;
      if (rank < live) w |= pos_sh[warp][rank] << (8 * j);
    }
    pos[r * (kExcCap / 4) + lane] = static_cast<int32_t>(w);
  }
}

}  // namespace dct

// zs [R, 128] u32 (int32 bit patterns), b [R] -> pos [R, 4], vals [R, 16].
extern "C" int dct_exc_extract(const void* zs, const void* b, void* pos,
                               void* vals, int num_rows, void* stream) {
  const unsigned grid = static_cast<unsigned>(
      (static_cast<long long>(num_rows) + dct::kExcWarps - 1) / dct::kExcWarps);
  dct::exc_extract_kernel<<<grid, dct::kExcWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(zs), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(vals), num_rows);
  return static_cast<int>(cudaGetLastError());
}
