// K5b: RICE bit unpacker, the frame's compact words -> zigzag values
// (FORMAT §2).
//
// Replaces dctpu/kernels/attic/unpack_pallas.py _unpack_kernel. It reads
// each block's payload where it lies in the frame's concatenated disk words,
// words[start_i : start_i + count_i] (the sync table, then the bitstream):
// no staged row is built. A read at index j of the block takes index
// min(j, padded_words(L) + 1) and gives 0 at or past count_i, which is the
// zero padding and the clamp of the plain twin
// (unpack(pad_payload(words, start, count, padded_words(L) + 2))), so the
// two agree on every input and no block reads another's words.
//
// What bounds it on the card: the codewords of one sub-block follow each
// other, so each sub-block's decode is a chain of up to 128 dependent steps
// (a 64-bit window, a count of trailing ones, a shift); the bytes are about
// 1 read and 4 written per sample. A chain that waits for device memory at
// its refills waits at nearly every step, since some lane of the warp
// refills at each one. Design: a thread block of one warp per codec block,
// lane = sub-block (a block of more than 32 sub-blocks is walked 32 at a
// time). The warp first copies its block's words into shared memory with
// coalesced cp.async copies, one wait for the whole block; the buffer holds
// min(padded_words(L) + 2, kUnpackMaxBufWords) words (16 bits a sample at
// block_len 4096, where meter data takes about 8), and a block with more
// words is read from device memory in place instead. The buffer is kept
// small because the chains need many warps per SM (24 here) more than they
// need the rare large block in shared memory. A warp-shuffle scan of the
// sub lengths gives the start bits. Each lane
// keeps its bits in registers, like the TPU kernel's shift buffer: a window
// of three words w0..w2 at a bit shift s < 32 (at least 64 bits, an escape
// takes 48) and the next word w3, read one refill ahead. A codeword advances
// s by at most 48 bits, so at most two refills follow it, each one 32-bit
// read. Each lane's kPhase decoded values at a time go through a
// [32][kPhase + 1] shared tile so that the warp stores 32 / kPhase
// sub-blocks' kPhase consecutive samples (32 bytes each) per instruction.
#include "bitplane.cuh"

namespace dct {

constexpr int kUnpackMaxBufWords = 2048;  // 8 KB
constexpr int kPhase = 8;  // codewords per lane between stores

__global__ void __launch_bounds__(32)
rice_unpack_words_kernel(const uint32_t* __restrict__ words,
                         const int64_t* __restrict__ start,
                         const int32_t* __restrict__ count,
                         const int32_t* __restrict__ k,
                         const int32_t* __restrict__ n,
                         int32_t* __restrict__ z, int block_len,
                         int row_words, int buf_words) {
  extern __shared__ uint32_t buf[];  // buf_words
  __shared__ uint32_t sh[32][kPhase + 1];

  const int lane = threadIdx.x;
  const int blk = blockIdx.x;
  const uint32_t* src = words + start[blk];
  const int last = row_words - 1;
  // the block's words that the twin's row holds: [0, min(count, row_words))
  const int held = min(count[blk], row_words);
  const uint32_t* bw = src;
  if (held <= buf_words) {
    for (int i = lane; i < held; i += 32) copy_async4(buf + i, src + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    bw = buf;
  }
  // word j of the block, as the twin's zero-padded, clamped row holds it
  auto word = [&](int j) -> uint32_t {
    j = min(j, last);
    return j < held ? bw[j] : 0u;
  };
  int32_t* zrow = z + static_cast<size_t>(blk) * block_len;

  const int subs = (block_len + kSub - 1) / kSub;
  const int steps = min(kSub, block_len);
  // k <= 30 in a valid frame (FORMAT §2); the clamp only keeps shifts defined
  const uint32_t kb = min(static_cast<uint32_t>(k[blk]), 31u);
  const uint32_t kmask = static_cast<uint32_t>((1ull << kb) - 1);
  const int nb = n[blk];
  int base = ((subs + 1) >> 1) * 32;  // the bitstream starts after the sync table

  for (int g = 0; g < subs; g += 32) {
    const int sub = g + lane;
    const bool live = sub < subs;
    const int len =
        live ? static_cast<int>((word(sub >> 1) >> (16 * (sub & 1))) & 0xFFFFu) : 0;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    const int p = base + incl - len;
    base += __shfl_sync(kFull, incl, 31);
    const int cap = live ? min(kSub, block_len - sub * kSub) : 0;
    const int n_sub = max(0, min(nb - sub * kSub, cap));

    // the lane's bits from p on: (w2:w1:w0) >> s, then w3; j = next word
    int j = p >> 5;
    uint32_t s = p & 31;
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    if (n_sub > 0) {
      w0 = word(j);
      w1 = word(j + 1);
      w2 = word(j + 2);
      w3 = word(j + 3);
    }
    j += 4;

    for (int t0 = 0; t0 < steps; t0 += kPhase) {
      for (int c = 0; c < kPhase; ++c) {
        uint32_t v = 0;
        if (t0 + c < n_sub) {
          const uint32_t lo = __funnelshift_r(w0, w1, s);
          const uint32_t hi = __funnelshift_r(w1, w2, s);
          const int ones = lo == kFull ? 32 : __ffs(~lo) - 1;
          if (ones >= 16) {  // escape: the 32 raw bits after 16 ones
            v = __funnelshift_r(lo, hi, 16);
            s += 48;
          } else {           // q = ones, then a zero, then the low k bits
            const uint32_t low = __funnelshift_r(lo, hi, ones + 1);
            v = (static_cast<uint32_t>(ones) << kb) | (low & kmask);
            s += ones + 1 + kb;
          }
          // s < 80 here: at most two refills
          if (s >= 32) {
            w0 = w1; w1 = w2; w2 = w3; w3 = word(j++);
            s -= 32;
          }
          if (s >= 32) {
            w0 = w1; w1 = w2; w2 = w3; w3 = word(j++);
            s -= 32;
          }
        }
        sh[lane][c] = v;
      }
      __syncwarp();
      for (int r0 = 0; r0 < 32; r0 += 32 / kPhase) {
        const int r = r0 + lane / kPhase;
        const int t = t0 + lane % kPhase;
        if (g + r < subs && t < min(kSub, block_len - (g + r) * kSub))
          zrow[(g + r) * kSub + t] = static_cast<int32_t>(sh[r][lane % kPhase]);
      }
      __syncwarp();
    }
  }
}

}  // namespace dct

// words [W] the frame's payload words (int32 bit patterns), start [B] int64
// and count [B] int32 each block's words, k [B], n [B] -> z [B, L] zigzag
// values (zero past n). row_words = padded_words(L) + 2, the twin's row.
extern "C" int dct_rice_unpack_words(const void* words, const void* start,
                                     const void* count, const void* k,
                                     const void* n, void* z, int num_blocks,
                                     int block_len, int row_words,
                                     void* stream) {
  const int buf_words = min(row_words, dct::kUnpackMaxBufWords);
  dct::rice_unpack_words_kernel<<<static_cast<unsigned>(num_blocks), 32,
                                  buf_words * sizeof(uint32_t),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(start),
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(n), static_cast<int32_t*>(z), block_len,
      row_words, buf_words);
  return static_cast<int>(cudaGetLastError());
}
