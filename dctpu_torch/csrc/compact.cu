// CP: the encode's compaction, a range's payload rows -> its compact disk
// words (FORMAT §2.1), every block's words written at its frame offset;
// and its count pass, which gives each block's word count, frame offset
// and source row.
//
// Replaces the reference's XLA compaction (dctpu/kernels/ragged.py
// compact_rice_semi and compact_vertical_semi), its host squeeze
// (squeeze_host) and the host interleave of the coder groups in block order
// (dctpu/codec/api.py, _compress_adaptive), with its word counts and
// offsets. It was no Pallas kernel on the TPU. One count pass and one copy
// cover a whole encode range: block b's payload row is row src[b] of the
// first coder group's rows (src[b] >= 0) or row -1 - src[b] of the
// second's (src[b] < 0), as in R's range form, and its wc[b] words land at
// out[off[b]]. wc follows the reference: RICE sync_words +
// ceil(bit_len / 32), VERTICAL sync_words + bit_len / 32.
//
// The count pass (one CTA, each warp a run of blocks read 32 at a time)
// reads each block's coder and bit length and writes wc, off (the
// exclusive scan of wc), src (the block's rank in its coder group, the
// RICE group first where the range has one: the order the encode stacks
// the groups' rows in, kernels/compact.py CODER_GROUPS) and the range's
// total. The host reads the total, sizes out and launches the copy.
//
// A RICE block's words are its row's first wc[b]. A VERTICAL row is staged
// ([sync words | one kRegionPad-word slot per sub-block], kernels/vertical.py):
// its words are the sync words, then each slot's live prefix, whose length
// its sync entry gives (region_word_counts, value_word_count).
//
// A VERTICAL block whose sync table has a width above 32, more than
// kExcCap exceptions in an entry, or counts that do not sum to wc[b] -
// sync_words sets bit kBadTable of the flag; a block whose source row lies
// outside its group, or whose words do not fit its row, sets kBadRow. Such
// a block writes no words; its warp ORs the bit into the flag word, which
// sits behind the range's words, at out[total] (zeroed by the entry point
// before the launch), so that the wrapper reads it in the same host read
// as the words.
//
// What bounds the copy on the card: the bytes, each live word read once
// and written once (~0.0185 ms for the 31 MB of a 128 MiB adaptive range).
// The frame offsets have no alignment, so the stores are 4-byte, coalesced
// by lane. Design: a warp per codec block, kCompactWarps to a CTA, with no
// shared memory and no block barrier, so a warp starts its copy as soon as
// its own loads return. A VERTICAL warp reads its sync entries one slot a
// lane, 32 slots a pass (up to kMaxSubs, 16 passes, with a carry), and
// takes the exclusive scan of their live words with __shfl_up_sync; the
// offsets stay in registers. It checks every pass before it writes a
// word, then copies its sync words and its passes in turn: the lanes
// walk a pass's words as one flat index, 32 consecutive words a step,
// each word finding its slot by a five-step __shfl_sync search of the
// lane-held offsets, with kUnroll independent loads in flight a lane
// before their stores. Each word is read once and written once, so the
// copies load and store with the streaming hint (__ldcs, __stcs: evict
// first).
//
// What still holds it back: a VERTICAL slot's live words (~30 at L = 4096)
// start at a 768-byte stride in a staged row of ~24 KB, so its reads end
// in partly used sectors and spread over many lines, and each word waits
// on its five-step search before its load; a RICE block's copy is a
// plain prefix. Variants timed on the H100 by cp_variants.py (the
// adaptive range's CP at 49 % of its bound): VERTICAL blocks copied as
// plain prefixes, with no scan and no search, reach 67 %; 4 or 16 loads
// in flight a lane, plain loads and stores, 16-byte loads of a RICE
// prefix (with strided or with shuffled 4-byte stores) and grids of 1, 2
// or 4 CTAs an SM whose warps walk the blocks are each as fast or slower.
#include "bitplane.cuh"

namespace dct {

constexpr int kCompactWarps = 8;  // codec blocks in flight a CTA
constexpr int kCompactThreads = kCompactWarps * 32;
constexpr int kUnroll = 8;        // loads in flight a lane
constexpr int kCountThreads = 1024;  // the count pass's one CTA
constexpr int kCountUnroll = 8;      // a count lane's loads in flight
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

__device__ __forceinline__ long long block_words(bool vertical,
                                                 long long bit_len, int sw) {
  return sw + (vertical ? bit_len >> 5 : (bit_len + 31) >> 5);
}

// Inclusive scan of (a, b) over a warp's lanes.
__device__ __forceinline__ void warp_scan(long long& a, int& b, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long oa = __shfl_up_sync(kFull, a, d);
    const int ob = __shfl_up_sync(kFull, b, d);
    if (lane >= d) a += oa, b += ob;
  }
}

// Block i's VERTICAL flag and words (none past num_blocks).
__device__ __forceinline__ long long count_of(const int32_t* __restrict__ coder,
                                             const int64_t* __restrict__ bit_len,
                                             int i, int num_blocks, int sw,
                                             bool& v) {
  v = i < num_blocks && coder[i] == kCoderVertical;
  return i < num_blocks ? block_words(v, bit_len[i], sw) : 0;
}

// The count pass: warp w takes a run of consecutive blocks, read 32 at a
// time, lane by lane (coalesced); it sums the run's words and VERTICAL
// blocks, the CTA scans the 32 sums, then the warp walks its run again
// with a warp scan and writes each block's wc, off and src.
__global__ void __launch_bounds__(kCountThreads)
count_range_kernel(const int32_t* __restrict__ coder,
                   const int64_t* __restrict__ bit_len, int num_blocks,
                   int block_len, int64_t* __restrict__ wc,
                   int64_t* __restrict__ off, int32_t* __restrict__ src,
                   int64_t* __restrict__ total) {
  __shared__ long long warp_words[32];
  __shared__ int warp_vert[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sw = (subs + 1) >> 1;
  // a run of whole 32-block steps a warp
  const int per = ((num_blocks + kCountThreads - 1) / kCountThreads) * 32;
  const int b0 = warp * per;
  const int b1 = min(b0 + per, num_blocks);
  long long words = 0;
  int vert = 0;
  for (int b = b0; b < b1; b += 32 * kCountUnroll) {
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      const int i = b + u * 32 + lane;
      bool v;
      words += count_of(coder, bit_len, i < b1 ? i : num_blocks, num_blocks,
                        sw, v);
      vert += v;
    }
  }
  warp_scan(words, vert, lane);
  if (lane == 31) warp_words[warp] = words, warp_vert[warp] = vert;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_words[lane];
    int v = warp_vert[lane];
    warp_scan(w, v, lane);
    warp_words[lane] = w, warp_vert[lane] = v;
  }
  __syncthreads();
  // the words and VERTICAL blocks before the run
  long long w_at = warp > 0 ? warp_words[warp - 1] : 0;
  int v_at = warp > 0 ? warp_vert[warp - 1] : 0;
  const bool vert_first = warp_vert[31] == num_blocks;  // no RICE block
  for (int b = b0; b < b1; b += 32) {  // again, from L1
    const int i = b + lane;
    bool v;
    const long long n = count_of(coder, bit_len, i < b1 ? i : num_blocks,
                                 num_blocks, sw, v);
    long long n_incl = n;
    int v_incl = v;
    warp_scan(n_incl, v_incl, lane);
    if (i < b1) {
      wc[i] = n;
      off[i] = w_at + n_incl - n;
      const int v_before = v_at + v_incl - v;
      const int rank = v ? v_before : i - v_before;
      src[i] = v == vert_first ? rank : -1 - rank;
    }
    w_at += __shfl_sync(kFull, n_incl, 31);
    v_at += __shfl_sync(kFull, v_incl, 31);
  }
  if (threadIdx.x == 0) *total = warp_words[31];
}

// Pass p of a VERTICAL row's slots, one a lane: slot p * 32 + lane's
// offset from the pass's first body word in excl; returns the pass's
// words. ok falls where the lane's sync entry is bad.
__device__ __forceinline__ int scan_pass(const int32_t* __restrict__ row,
                                         int p, int subs, int block_len,
                                         int lane, bool& ok, int& excl) {
  const int s = p * 32 + lane;
  int cnt = 0;
  if (s < subs) {
    const uint32_t entry =
        (static_cast<uint32_t>(__ldg(row + (s >> 1))) >> (16 * (s & 1))) & 0xFFFFu;
    cnt = slot_words(entry, plane_words(s, block_len), ok);
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  excl = incl - cnt;
  return __shfl_sync(kFull, incl, 31);
}

// Words [0, count) of src to dst, kUnroll coalesced loads a lane in flight.
__device__ __forceinline__ void copy_words(const int32_t* __restrict__ src,
                                           int32_t* __restrict__ dst,
                                           int count, int lane) {
  for (int i0 = 0; i0 < count; i0 += kUnroll * 32) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32 + lane;
      v[u] = i < count ? __ldcs(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32 + lane;
      if (i < count) __stcs(dst + i, v[u]);
    }
  }
}

// One pass's words [0, total) to dst: word j is word j - excl_s of slot
// s's staged words at src + s * kRegionPad, s the last lane whose
// excl <= j (an empty slot shares its offset with the slot after it).
__device__ __forceinline__ void copy_pass(const int32_t* __restrict__ src,
                                          int32_t* __restrict__ dst, int excl,
                                          int total, int lane) {
  for (int j0 = 0; j0 < total; j0 += kUnroll * 32) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      int s = 0, at = 0;  // lane 0's excl is 0
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int e = __shfl_sync(kFull, excl, s + step);
        if (e <= j) s += step, at = e;
      }
      v[u] = j < total ? __ldcs(src + s * kRegionPad + (j - at)) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * 32 + lane;
      if (j < total) __stcs(dst + j, v[u]);
    }
  }
}

// The two coder groups' rows (fields, not arrays: a kernel parameter
// indexed at run time would be copied to local memory).
struct Groups {
  const int32_t* rows_a;
  const int32_t* rows_b;
  int num_a, num_b, width_a, width_b;
};

// One warp copies block blk's words; returns its flag bits.
__device__ __forceinline__ int compact_block(
    const Groups& g, const int32_t* __restrict__ src,
    const int32_t* __restrict__ coder, const int64_t* __restrict__ wc,
    const int64_t* __restrict__ off, int32_t* __restrict__ out, int blk,
    int subs, int sw, int block_len, int lane) {
  const bool vertical = coder[blk] == kCoderVertical;
  const int s_row = src[blk];
  const long long words = wc[blk];
  const long long at = off[blk];
  const bool first = s_row >= 0;
  const int r = first ? s_row : -1 - s_row;
  const int width = first ? g.width_a : g.width_b;
  // every test here is uniform over the warp
  const bool fits = vertical ? width >= sw + subs * kRegionPad
                             : words >= sw && words <= width;
  if (r >= (first ? g.num_a : g.num_b) || !fits) return kBadRow;
  const int32_t* row =
      (first ? g.rows_a : g.rows_b) + static_cast<size_t>(r) * width;
  int32_t* dst = out + at;
  if (!vertical) {
    copy_words(row, dst, static_cast<int>(words), lane);
    return 0;
  }
  const int passes = (subs + 31) >> 5;
  bool ok = true;
  int excl0;
  const int total0 = scan_pass(row, 0, subs, block_len, lane, ok, excl0);
  int body = total0;
  for (int p = 1; p < passes; ++p) {
    int excl;
    body += scan_pass(row, p, subs, block_len, lane, ok, excl);
  }
  if (!__all_sync(kFull, ok) || sw + body != words) return kBadTable;
  copy_words(row, dst, sw, lane);
  copy_pass(row + sw, dst + sw, excl0, total0, lane);
  int done = sw + total0;
  for (int p = 1; p < passes; ++p) {  // offsets scanned again, from L1
    int excl;
    const int t = scan_pass(row, p, subs, block_len, lane, ok, excl);
    copy_pass(row + sw + p * 32 * kRegionPad, dst + done, excl, t, lane);
    done += t;
  }
  return 0;
}

__global__ void __launch_bounds__(kCompactThreads)
compact_range_kernel(Groups g, const int32_t* __restrict__ src,
                     const int32_t* __restrict__ coder,
                     const int64_t* __restrict__ wc,
                     const int64_t* __restrict__ off, int32_t* __restrict__ out,
                     int32_t* __restrict__ flag, int num_blocks,
                     int block_len) {
  const int lane = threadIdx.x & 31;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sw = (subs + 1) >> 1;  // sync words
  // One block a warp at the launch's grid, written as a loop over the
  // grid's warps: on the H100 this body ran faster than the same one
  // after an early return of the warps past num_blocks (cp_variants.py).
  int bad = 0;
  for (int blk = blockIdx.x * kCompactWarps + (threadIdx.x >> 5);
       blk < num_blocks; blk += gridDim.x * kCompactWarps) {
    bad |= compact_block(g, src, coder, wc, off, out, blk, subs, sw,
                         block_len, lane);
  }
  if (bad && lane == 0) atomicOr(flag, bad);
}

}  // namespace dct

// coder [B] int32 and bit_len [B] int64 -> wc [B] and off [B] int64 each
// block's words and their offset, src [B] int32 each block's row in its
// coder group's rows (>= 0 the first group, the RICE one where the range
// has a RICE block; < 0 row -1 - src of the second), total [1] int64 the
// range's words.
extern "C" int dct_count_range(const void* coder, const void* bit_len,
                               void* wc, void* off, void* src, void* total,
                               int num_blocks, int block_len, void* stream) {
  dct::count_range_kernel<<<1, dct::kCountThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coder), static_cast<const int64_t*>(bit_len),
      num_blocks, block_len, static_cast<int64_t*>(wc),
      static_cast<int64_t*>(off), static_cast<int32_t*>(src),
      static_cast<int64_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

// rows_a [num_a, width_a] and rows_b [num_b, width_b] the two coder groups'
// payload rows (int32 bit patterns; rows_b may be null with num_b 0),
// src [B] each block's row (>= 0: row of rows_a; < 0: row -1 - src of
// rows_b), coder [B], wc [B] and off [B] int64 the count pass's ->
// out[off[b] : off[b] + wc[b]] the block's disk words, and *flag |= 1 (a
// VERTICAL block's sync table does not describe its words) | 2 (a source
// row or a word count does not fit the rows), *flag zeroed first.
extern "C" int dct_compact_range(const void* rows_a, int num_a, int width_a,
                                 const void* rows_b, int num_b, int width_b,
                                 const void* src, const void* coder,
                                 const void* wc, const void* off, void* out,
                                 void* flag, int num_blocks, int block_len,
                                 void* stream) {
  const dct::Groups g{static_cast<const int32_t*>(rows_a),
                      static_cast<const int32_t*>(rows_b), num_a, num_b,
                      width_a, width_b};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (num_blocks + dct::kCompactWarps - 1) / dct::kCompactWarps;
  dct::compact_range_kernel<<<static_cast<unsigned>(ctas > 0 ? ctas : 1),
                              dct::kCompactThreads, 0, st>>>(
      g, static_cast<const int32_t*>(src), static_cast<const int32_t*>(coder),
      static_cast<const int64_t*>(wc), static_cast<const int64_t*>(off),
      static_cast<int32_t*>(out), static_cast<int32_t*>(flag), num_blocks,
      block_len);
  return static_cast<int>(cudaGetLastError());
}
