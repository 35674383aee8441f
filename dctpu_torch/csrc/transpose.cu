// K9: the bit planes of [R, 128] u32 rows, in disk order.
//
// Replaces dctpu/kernels/transpose_pallas.py:83 _transpose_kernel
// (grouped_bit_transpose32). Each 32-word group w of a row is one 32x32 bit
// matrix; output word p * 4 + w of the row is its plane p: bit c = bit p of
// input word 32 w + c. That is the plane order of the VERTICAL payload
// (vertical_xla.encode_vertical's swapaxes(bit_transpose32(zg), 2, 3)),
// where the TPU kernel gave the groups lane-reversed, a Mosaic limit the
// caller undid with two flips and a transpose.
//
// What bounds it on the card: 4 bytes read and 4 written per word against
// the ~15 integer ops per word of the masked-swap network (five stages of
// 16 swaps of 6 ops on 32 words): bytes. A warp per row, lane j holding
// word j of each group (four coalesced 4-byte loads); the five stages of
// the masked-swap network (the masks of transpose_pallas.py and of
// vertical_xla.bit_transpose32) run across the lanes with shfl_xor, after
// which lane p holds plane p of the four groups: one 16-byte store in disk
// order. A thread-per-group route (a 16-byte-load shared tile, the swaps in
// 32 registers) measured no faster on the H100 (PERF.md §6).
#include "bitplane.cuh"

namespace dct {

constexpr int kPlaneThreads = 256;  // eight rows per block

// Stage J of the masked-swap network with word k in lane k: the bits of
// mask M of word k + J trade places with the bits above them in word k,
// the partner's word by shfl_xor.
template <int J, uint32_t M>
__device__ __forceinline__ uint32_t swap_lanes(uint32_t a, bool upper) {
  const uint32_t b = __shfl_xor_sync(kFull, a, J);
  return upper ? (a & ~M) | ((b >> J) & M) : (a & M) | ((b << J) & ~M);
}

__global__ void __launch_bounds__(kPlaneThreads)
bit_planes_kernel(const uint32_t* __restrict__ in, uint4* __restrict__ out,
                  int num_rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPlaneThreads / 32) +
      (threadIdx.x >> 5);
  if (row >= num_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const uint32_t* src = in + row * kSub;
  uint32_t a[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) a[w] = src[32 * w + lane];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a[w] = swap_lanes<16, 0x0000FFFFu>(a[w], lane & 16);
    a[w] = swap_lanes<8, 0x00FF00FFu>(a[w], lane & 8);
    a[w] = swap_lanes<4, 0x0F0F0F0Fu>(a[w], lane & 4);
    a[w] = swap_lanes<2, 0x33333333u>(a[w], lane & 2);
    a[w] = swap_lanes<1, 0x55555555u>(a[w], lane & 1);
  }
  out[row * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
}

}  // namespace dct

// rows [R, 128] u32 (int32 bit patterns) -> out [R, 128] disk-order planes
// (16-byte aligned).
extern "C" int dct_bit_planes32(const void* rows, void* out, int num_rows,
                                void* stream) {
  constexpr int per = dct::kPlaneThreads / 32;
  dct::bit_planes_kernel<<<(num_rows + per - 1) / per, dct::kPlaneThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<uint4*>(out), num_rows);
  return static_cast<int>(cudaGetLastError());
}
