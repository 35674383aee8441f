// CP: the encode's compaction, a range's payload rows -> its compact disk
// words (FORMAT §2.1), every block's words written at its frame offset.
//
// Replaces the reference's XLA compaction (dctpu/kernels/ragged.py
// compact_rice_semi and compact_vertical_semi), its host squeeze
// (squeeze_host) and the host interleave of the coder groups in block order
// (dctpu/codec/api.py, _compress_adaptive). It was no Pallas kernel on the
// TPU. One launch covers a whole encode range: block b's payload row is row
// src[b] of the first coder group's rows (src[b] >= 0) or row -1 - src[b]
// of the second's (src[b] < 0), as in R's range form, and its wc[b] words
// land at out[off[b]], off being the exclusive scan of wc that the wrapper
// takes. wc follows the reference: RICE sync_words + ceil(bit_len / 32),
// VERTICAL sync_words + bit_len / 32.
//
// A RICE block's words are its row's first wc[b]. A VERTICAL row is staged
// ([sync words | one kRegionPad-word slot per sub-block], kernels/vertical.py):
// its words are the sync words, then each slot's live prefix, whose length
// its sync entry gives (region_word_counts, value_word_count). The block
// scans those counts over its slots, up to kMaxSubs of them, in chunks of
// the CTA's threads.
//
// A VERTICAL block whose sync table has a width above 32, more than
// kExcCap exceptions in an entry, or counts that do not sum to wc[b] -
// sync_words sets bit kBadTable of *flag; a block whose source row lies
// outside its group, or whose words do not fit its row, sets kBadRow. Such
// a block writes no words. The wrapper reads the flag word, which sits
// after the range's words, in the same host read as the words.
//
// What bounds it on the card: the bytes, each live word read once and
// written once (~0.02 ms for the 31 MB of a 128 MiB adaptive range). The
// frame offsets have no alignment, so the copies are 4-byte, coalesced by
// thread. Design: a CTA of kCompactThreads per block; a VERTICAL block
// first scans its slot counts into shared memory (2 KB), then every thread
// copies words t, t + kCompactThreads, ... of the block, kUnroll loads in
// flight before their stores, finding a body word's slot by a binary
// search of the scanned offsets.
#include "bitplane.cuh"

namespace dct {

constexpr int kCompactThreads = 128;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kUnroll = 4;
constexpr int kCoderVertical = 1;  // CODER_VERTICAL; every other id is RICE
constexpr int kBadTable = 1;
constexpr int kBadRow = 2;

// Live words of a slot from its u16 sync entry, and whether the entry can
// be right (b <= 32, n_exc <= kExcCap).
__device__ __forceinline__ int slot_words(uint32_t entry, int pw, bool& ok) {
  const int b = entry & 63;
  const int n_exc = (entry >> 6) & 31;
  const int e = n_exc > 0 ? ((entry >> 11) & 31) + 1 : 0;
  ok = ok && b <= 32 && n_exc <= kExcCap;
  const int vw = n_exc > 0 ? min(n_exc, (e + 1) >> 1) : 0;
  return pw * b + ((n_exc + 3) >> 2) + vw;
}

// The last slot s whose first body word is at or before j (slot_off[0] = 0;
// an empty slot shares its offset with the slot after it).
__device__ __forceinline__ int slot_of(const int* slot_off, int subs, int j) {
  int lo = 0, hi = subs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (slot_off[mid] <= j) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kCompactThreads)
compact_range_kernel(const int32_t* __restrict__ rows_a, int num_a, int width_a,
                     const int32_t* __restrict__ rows_b, int num_b, int width_b,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ coder,
                     const int64_t* __restrict__ wc,
                     const int64_t* __restrict__ off,
                     int32_t* __restrict__ out, int32_t* __restrict__ flag,
                     int block_len) {
  __shared__ int slot_off[kMaxSubs];
  __shared__ int warp_sum[kCompactWarps];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sw = (subs + 1) >> 1;  // sync words
  const bool vertical = coder[blk] == kCoderVertical;
  const int s_row = src[blk];
  const bool first = s_row >= 0;
  const int r = first ? s_row : -1 - s_row;
  const int width = first ? width_a : width_b;
  const int64_t words = wc[blk];

  // every test here is uniform over the CTA
  const bool fits = vertical ? width >= sw + subs * kRegionPad
                             : words >= sw && words <= width;
  if (r >= (first ? num_a : num_b) || !fits) {
    if (tid == 0) atomicOr(flag, kBadRow);
    return;
  }
  const int32_t* row = (first ? rows_a : rows_b) + static_cast<size_t>(r) * width;
  int32_t* dst = out + off[blk];

  if (vertical) {
    int carry = 0;
    bool ok = true;
    for (int base = 0; base < subs; base += kCompactThreads) {
      const int s = base + tid;
      int cnt = 0;
      if (s < subs) {
        const uint32_t entry =
            (static_cast<uint32_t>(row[s >> 1]) >> (16 * (s & 1))) & 0xFFFFu;
        cnt = slot_words(entry, plane_words(s, block_len), ok);
      }
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      int before = carry, chunk = 0;
#pragma unroll
      for (int w = 0; w < kCompactWarps; ++w) {
        before += w < warp ? warp_sum[w] : 0;
        chunk += warp_sum[w];
      }
      if (s < subs) slot_off[s] = before + incl - cnt;
      carry += chunk;
      __syncthreads();  // warp_sum is rewritten by the next chunk
    }
    if (!__syncthreads_and(ok) || sw + carry != words) {
      if (tid == 0) atomicOr(flag, kBadTable);
      return;
    }
  }

  const int count = static_cast<int>(words);  // <= width: checked above
  // word i of the block comes from row[i] (RICE, and the sync words), or
  // from its slot's staged words
  auto from = [&](int i) -> int {
    if (!vertical || i < sw) return i;
    const int j = i - sw;
    const int s = slot_of(slot_off, subs, j);
    return sw + s * kRegionPad + (j - slot_off[s]);
  };
  for (int i0 = tid; i0 < count; i0 += kUnroll * kCompactThreads) {
    int32_t v[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kCompactThreads;
      if (i < count) v[u] = __ldg(row + from(i));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kCompactThreads;
      if (i < count) dst[i] = v[u];
    }
  }
}

}  // namespace dct

// rows_a [num_a, width_a] and rows_b [num_b, width_b] the two coder groups'
// payload rows (int32 bit patterns; rows_b may be null with num_b 0),
// src [B] each block's row (>= 0: row of rows_a; < 0: row -1 - src of
// rows_b), coder [B], wc [B] and off [B] int64 each block's words and their
// offset in out -> out[off[b] : off[b] + wc[b]] the block's disk words, and
// *flag |= 1 (a VERTICAL block's sync table does not describe its words) or
// 2 (a source row or a word count does not fit the rows). *flag is zeroed
// by the caller.
extern "C" int dct_compact_range(const void* rows_a, int num_a, int width_a,
                                 const void* rows_b, int num_b, int width_b,
                                 const void* src, const void* coder,
                                 const void* wc, const void* off, void* out,
                                 void* flag, int num_blocks, int block_len,
                                 void* stream) {
  dct::compact_range_kernel<<<static_cast<unsigned>(num_blocks),
                              dct::kCompactThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows_a), num_a, width_a,
      static_cast<const int32_t*>(rows_b), num_b, width_b,
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(coder),
      static_cast<const int64_t*>(wc), static_cast<const int64_t*>(off),
      static_cast<int32_t*>(out), static_cast<int32_t*>(flag), block_len);
  return static_cast<int>(cudaGetLastError());
}
