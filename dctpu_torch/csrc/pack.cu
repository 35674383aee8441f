// K5a: RICE bit packer, zigzag values -> payload rows (FORMAT §2, §2.1).
//
// Replaces dctpu/kernels/attic/pack_pallas.py _pack_kernel together with
// the XLA around it (rice.codewords before it; the sync table and bit_len,
// which the TPU wrapper computed outside the kernel). Output row per block:
// the sync table (sub-block code bit lengths as u16 pairs), then the
// bitstream, each codeword at the bit offset given by the exclusive prefix
// sum of the code lengths before it, bit 0 = first stream bit.
//
// What bounds it on the card: one 4-byte read and at most 6 bytes written
// per sample against a block-wide scan and up to three ORs per codeword:
// bytes, not operations, once the scan is cheap. The TPU kernel's prepend
// scan and merge pyramid existed because Mosaic has no dynamic-offset
// stores. Here a thread can OR into any word, so the design is direct: one
// thread block of 128 threads per codec block walks its 128-sample
// sub-blocks; each thread forms its sample's codeword (at most 48 bits) in
// registers, a warp-shuffle scan plus a 4-warp sum gives its bit offset and
// the sub-block's sync entry, and the codeword ORs into at most three words
// of the row. The row (24.6 KB at block_len 4096) is built in shared
// memory, where neighbouring codewords' shared words take atomicOr, and
// stored once, coalesced. Rows larger than kSmemBytes (block_len above
// ~8000; FORMAT allows 65535) are zeroed and ORed in device memory instead.
#include "bitplane.cuh"

namespace dct {

constexpr int kSmemBytes = 48 * 1024;  // largest row built in shared memory

template <bool SMEM>
__global__ void __launch_bounds__(kSub)
rice_pack_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ k,
                 const int32_t* __restrict__ n, int32_t* __restrict__ payload,
                 long long* __restrict__ bit_len, int block_len, int row_words) {
  extern __shared__ uint32_t smem_row[];
  __shared__ int warp_sum[kWarps];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sync_words = (subs + 1) >> 1;
  uint32_t* out =
      reinterpret_cast<uint32_t*>(payload) + static_cast<size_t>(blk) * row_words;
  uint32_t* row = SMEM ? smem_row : out;
  for (int t = tid; t < row_words; t += kSub) row[t] = 0;
  __syncthreads();

  const int32_t* zrow = z + static_cast<size_t>(blk) * block_len;
  const int nb = min(n[blk], block_len);
  // k <= 30 in a valid frame (FORMAT §2); the clamp only keeps shifts defined
  const uint32_t kb = min(static_cast<uint32_t>(k[blk]), 31u);
  int base = 0;  // bits of the sub-blocks before this one
  for (int s = 0; s < subs; ++s) {
    const int i = s * kSub + tid;
    uint64_t code = 0;
    int len = 0;
    if (i < nb) {
      const uint32_t u = static_cast<uint32_t>(zrow[i]);
      const uint32_t q = u >> kb;
      if (q >= 16u) {  // escape: 16 ones, then the 32 raw bits
        code = 0xFFFFull | (static_cast<uint64_t>(u) << 16);
        len = 48;
      } else {         // q ones, a zero, the low k bits
        code = ((1ull << q) - 1) |
               (static_cast<uint64_t>(u & ((1u << kb) - 1)) << (q + 1));
        len = static_cast<int>(q + 1 + kb);
      }
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
    int sub_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int ws = warp_sum[w];
      before += w < warp ? ws : 0;
      sub_total += ws;
    }
    __syncthreads();  // warp_sum is rewritten by the next sub-block

    if (len) {
      const int off = base + before + incl - len;
      const int w = sync_words + (off >> 5);
      const int sh = off & 31;
      // the codeword spans words w..w+2; a word it does not reach gets 0
      // and is skipped, so the row's last word bounds every store
      const uint32_t v0 = static_cast<uint32_t>(code << sh);
      const uint32_t v1 = static_cast<uint32_t>((code << sh) >> 32);
      const uint32_t v2 = sh ? static_cast<uint32_t>(code >> (64 - sh)) : 0u;
      atomicOr(&row[w], v0);
      if (v1) atomicOr(&row[w + 1], v1);
      if (v2) atomicOr(&row[w + 2], v2);
    }
    if (tid == 0)
      atomicOr(&row[s >> 1], static_cast<uint32_t>(sub_total) << (16 * (s & 1)));
    base += sub_total;
  }
  if (tid == 0) bit_len[blk] = base;
  if constexpr (SMEM) {
    __syncthreads();
    for (int t = tid; t < row_words; t += kSub) out[t] = row[t];
  }
}

}  // namespace dct

// z [B, L] zigzag values (int32 bit patterns), k [B], n [B]
// -> payload [B, row_words] (sync table + bitstream), bit_len [B] int64.
extern "C" int dct_rice_pack(const void* z, const void* k, const void* n,
                             void* payload, void* bit_len, int num_blocks,
                             int block_len, int row_words, void* stream) {
  const size_t bytes = static_cast<size_t>(row_words) * sizeof(uint32_t);
  const bool in_smem = bytes <= static_cast<size_t>(dct::kSmemBytes);
  const auto kernel =
      in_smem ? dct::rice_pack_kernel<true> : dct::rice_pack_kernel<false>;
  kernel<<<num_blocks, dct::kSub, in_smem ? bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(n), static_cast<int32_t*>(payload),
      static_cast<long long*>(bit_len), block_len, row_words);
  return static_cast<int>(cudaGetLastError());
}
