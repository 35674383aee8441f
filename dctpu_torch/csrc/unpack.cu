// K5b: RICE bit unpacker, staged payload rows -> zigzag values (FORMAT §2).
//
// Replaces dctpu/kernels/attic/unpack_pallas.py _unpack_kernel. Input rows
// are the port's RICE staging (kernels/ragged.pad_payload): per block the
// sync table, the bitstream, zeros, and at least 2 slack words. The TPU
// kernel's shift-buffer state and its stage_rice_scan row layout existed
// because Mosaic has no dynamic-offset loads; they are not carried over.
//
// What bounds it on the card: the codewords of one sub-block follow each
// other, so each sub-block's decode is a chain of 128 dependent steps (a
// 64-bit window from three words, a count of trailing ones, a shift). It is
// bound by that latency, not by bytes (about 6 bytes read and 4 written per
// sample). Design: the sync table gives every 128-sample sub-block its
// start bit, so all sub-blocks decode at once: one warp per codec block,
// lane = sub-block (a block of more than 32 sub-blocks is walked 32 at a
// time), four codec blocks per thread block. A warp-shuffle scan of the
// sub lengths gives the start bits. Each lane's 32 decoded values at a time
// go through a [32][33] shared tile so that the warp stores one sub-block's
// 32 consecutive samples per instruction. Reads clamp to the row's last word,
// as the plain twin's gather does.
#include "bitplane.cuh"

namespace dct {

constexpr int kUnpackWarps = 4;  // codec blocks per thread block

__global__ void __launch_bounds__(32 * kUnpackWarps)
rice_unpack_kernel(const int32_t* __restrict__ payload,
                   const int32_t* __restrict__ k, const int32_t* __restrict__ n,
                   int32_t* __restrict__ z, int num_blocks, int block_len,
                   int row_words) {
  __shared__ uint32_t tile[kUnpackWarps][32][33];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blk = blockIdx.x * kUnpackWarps + warp;
  if (blk >= num_blocks) return;  // whole warps only; no block barrier below
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(payload) + static_cast<size_t>(blk) * row_words;
  int32_t* zrow = z + static_cast<size_t>(blk) * block_len;
  uint32_t(*sh)[33] = tile[warp];

  const int subs = (block_len + kSub - 1) / kSub;
  const int steps = min(kSub, block_len);
  // k <= 30 in a valid frame (FORMAT §2); the clamp only keeps shifts defined
  const uint32_t kb = min(static_cast<uint32_t>(k[blk]), 31u);
  const uint64_t kmask = (1ull << kb) - 1;
  const int nb = n[blk];
  const int last = row_words - 1;
  int base = ((subs + 1) >> 1) * 32;  // the bitstream starts after the sync table

  for (int g = 0; g < subs; g += 32) {
    const int sub = g + lane;
    const bool live = sub < subs;
    const int len =
        live ? static_cast<int>((row[sub >> 1] >> (16 * (sub & 1))) & 0xFFFFu) : 0;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    int p = base + incl - len;
    base += __shfl_sync(kFull, incl, 31);
    const int cap = live ? min(kSub, block_len - sub * kSub) : 0;
    const int n_sub = max(0, min(nb - sub * kSub, cap));

    for (int t0 = 0; t0 < steps; t0 += 32) {
      for (int c = 0; c < 32; ++c) {
        uint32_t v = 0;
        if (t0 + c < n_sub) {
          const int j = p >> 5;
          const int s = p & 31;
          const uint32_t w0 = row[min(j, last)];
          const uint32_t w1 = row[min(j + 1, last)];
          const uint32_t w2 = row[min(j + 2, last)];
          uint64_t x = ((static_cast<uint64_t>(w1) << 32) | w0) >> s;
          if (s) x |= static_cast<uint64_t>(w2) << (64 - s);
          const uint32_t lo = static_cast<uint32_t>(x);
          const uint32_t hi = static_cast<uint32_t>(x >> 32);
          const int ones = lo == kFull ? 32 : __ffs(~lo) - 1;
          if (ones >= 16) {  // escape: the 32 raw bits after 16 ones
            v = (lo >> 16) | (hi << 16);
            p += 48;
          } else {           // q = ones, then a zero, then the low k bits
            const uint32_t low = (lo >> (ones + 1)) | (hi << (31 - ones));
            v = static_cast<uint32_t>((static_cast<uint64_t>(ones) << kb) |
                                      (low & kmask));
            p += ones + 1 + static_cast<int>(kb);
          }
        }
        sh[lane][c] = v;
      }
      __syncwarp();
      for (int r = 0; r < 32 && g + r < subs; ++r) {
        const int t = t0 + lane;
        if (t < min(kSub, block_len - (g + r) * kSub))
          zrow[(g + r) * kSub + t] = static_cast<int32_t>(sh[r][lane]);
      }
      __syncwarp();
    }
  }
}

}  // namespace dct

// payload [B, row_words] staged RICE rows (int32 bit patterns), k [B], n [B]
// -> z [B, L] zigzag values (zero past n).
extern "C" int dct_rice_unpack(const void* payload, const void* k,
                               const void* n, void* z, int num_blocks,
                               int block_len, int row_words, void* stream) {
  const unsigned grid =
      (static_cast<unsigned>(num_blocks) + dct::kUnpackWarps - 1) / dct::kUnpackWarps;
  dct::rice_unpack_kernel<<<grid, 32 * dct::kUnpackWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(payload), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(n), static_cast<int32_t*>(z), num_blocks,
      block_len, row_words);
  return static_cast<int>(cudaGetLastError());
}
