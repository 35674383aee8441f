// Shared device helpers of the kernels (select.cu, vemit.cu, vdec.cu,
// exc.cu, transpose.cu, unpack.cu, recon.cu): one 128-sample sub-block row
// is four warps, lane c of warp w holding sample 32w + c (docs/FORMAT.md
// §2.2); and the 4-byte cp.async copy into shared memory.
//
// The TPU kernels built the bit planes with a 32x32 butterfly transpose plus
// a bit reversal (dctpu/kernels/select_bp.py _bt32_rows, vemit_pallas.py
// _bitrev32). On the card a warp vote does it directly:
// __ballot_sync(full, (z >> p) & 1) is plane word (p, w) in the disk bit
// order, bit c = sample 32w + c.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dct {

constexpr int kSub = 128;           // samples per sub-block row
constexpr int kWarps = kSub / 32;   // plane words per full row
constexpr int kExcCap = 16;         // EXC_CAP, normative (FORMAT §2.2)
constexpr int kRegionWords = 148;   // 128 plane + 4 position + 16 value words
constexpr int kRegionPad = 192;     // staged row stride of one sub-block
constexpr int kMaxSubs = 512;       // block_len < 65536: n is a u16 in the frame
constexpr unsigned kFull = 0xffffffffu;

// One 4-byte cp.async copy from device memory into shared memory; the
// caller waits for it (cp.async.wait_all, or commit_group and wait_group),
// then a barrier makes it visible to the other threads.
template <class T>
__device__ __forceinline__ void copy_async4(T* smem, const T* src) {
  static_assert(sizeof(T) == 4, "4-byte copies");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src));
}

// Bit length of a u32 (0 for 0).
__device__ __forceinline__ int bit_length(uint32_t z) {
  return 32 - __clz(static_cast<int>(z));
}

// Plane words of sub-block s: ceil(cap / 32), cap = samples the sub covers.
__device__ __forceinline__ int plane_words(int s, int block_len) {
  const int cap = min(kSub, block_len - s * kSub);
  return (cap + 31) >> 5;
}

// Lane b's value of v at bin b + d (v held one bin per lane), 0 past bin 32.
__device__ __forceinline__ int bin_above(int v, int d) {
  const int t = __shfl_down_sync(kFull, v, d);
  return (threadIdx.x & 31) + d < 32 ? t : 0;
}

// E[lane] = sum of v over lanes >= lane.
__device__ __forceinline__ int suffix_sum(int v) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) v += bin_above(v, d);
  return v;
}

// Exceed table of the current row: e_sh[b] = #{samples with bit length > b}
// for b in [0, 32) (E[32] is 0). All kSub threads call it with their
// sample's bit length. part is [kWarps][32] shared scratch. On return e_sh
// is complete and visible to warp 0, the only reader.
__device__ __forceinline__ void exceed_table(int bl, int (*part)[32],
                                             int* e_sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int mine = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int c = __popc(__ballot_sync(kFull, bl > b));
    if (lane == b) mine = c;
  }
  part[warp][lane] = mine;
  __syncthreads();
  if (warp == 0) {
    int e = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) e += part[w][lane];
    e_sh[lane] = e;
  }
  __syncthreads();
}

struct Width {
  int b;      // plane count
  int words;  // coded words of the row at width b
  int n_exc;  // exceptions at width b
  int e;      // bit length of the largest exception value (0 if none)
};

// FORMAT §2.2 width rule, one warp (lane = candidate b, eb = E[b] of the
// row): argmin over b of words(b) = pw*b + ceil(n_exc/4) + vw(b) among
// widths with n_exc <= 16, ties to the smallest b, as a packed
// (words*64 + b) key minimum. Same integers as
// dctpu/kernels/vertical_xla.py _select_width. All 32 lanes call it.
__device__ __forceinline__ Width select_width(int eb, int pw) {
  const int lane = threadIdx.x & 31;
  const int blmax = __popc(__ballot_sync(kFull, eb > 0));
  const int e_b = max(blmax - lane, 0);
  const int vw = eb > 0 ? min(eb, (e_b + 1) >> 1) : 0;
  int words = pw * lane + ((eb + 3) >> 2) + vw;
  if (eb > kExcCap) words = 1 << 24;
  int key = __reduce_min_sync(kFull, words * 64 + lane);
  key = min(key, pw * 32 * 64 + 32);  // b = 32 never has exceptions
  Width w;
  w.b = key & 63;
  w.words = key >> 6;
  const int at_b = __shfl_sync(kFull, eb, w.b & 31);
  w.n_exc = w.b < 32 ? at_b : 0;
  w.e = w.n_exc > 0 ? blmax - w.b : 0;
  return w;
}

// The width rule on an exceed table in shared memory (e_sh[b] = E[b]).
__device__ __forceinline__ Width select_width(const int* e_sh, int pw) {
  return select_width(e_sh[threadIdx.x & 31], pw);
}

}  // namespace dct
