// K9: grouped 32x32 bit-matrix transpose of [R, 128] u32 rows.
//
// Replaces dctpu/kernels/transpose_pallas.py _transpose_kernel
// (grouped_bit_transpose32). Each 32-word group of a row is one 32x32 bit
// matrix, in the TPU butterfly's lane-reversed order: with y the group's
// input words, output word l has bit c = bit (31 - l) of y[31 - c], so that
// rev(K9(rev(x))) == vertical_xla.bit_transpose32(x) (rev = the group's
// word order reversed).
//
// What bounds it on the card: it reads and writes 4 bytes per word with 64
// warp-level ops per word in between, so it is bound by memory traffic.
// Design: one warp per 32-word group, one word per lane (coalesced loads and
// stores). A vote __ballot_sync(full, (y >> p) & 1) gives mask m_p with bit j
// = bit p of y[j]; output lane 31 - p keeps __brev(m_p), which is the
// reversed order above. The TPU's grouped_roll butterfly is not carried over.
#include "bitplane.cuh"

namespace dct {

constexpr int kTransposeThreads = 256;  // 8 groups per thread block

__global__ void __launch_bounds__(kTransposeThreads)
bit_transpose_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                     long long words) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kTransposeThreads + threadIdx.x;
  // words is a multiple of 32, so a warp is wholly in range or wholly out
  if (i >= words) return;
  const int lane = threadIdx.x & 31;
  const uint32_t y = static_cast<uint32_t>(in[i]);
  uint32_t mine = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const uint32_t m = __ballot_sync(kFull, (y >> p) & 1u);
    if (lane == 31 - p) mine = __brev(m);
  }
  out[i] = static_cast<int32_t>(mine);
}

}  // namespace dct

// rows [R, 128] u32 (int32 bit patterns) -> out [R, 128].
extern "C" int dct_bit_transpose(const void* rows, void* out, int num_rows,
                                 void* stream) {
  const long long words = static_cast<long long>(num_rows) * dct::kSub;
  const unsigned grid = static_cast<unsigned>(
      (words + dct::kTransposeThreads - 1) / dct::kTransposeThreads);
  dct::bit_transpose_kernel<<<grid, dct::kTransposeThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(out), words);
  return static_cast<int>(cudaGetLastError());
}
