// K4: VERTICAL decode, the frame's compact words -> zigzag values
// (FORMAT §2.2).
//
// Replaces dctpu/kernels/vdec_pallas.py _vdec_kernel. It reads each block's
// payload where it lies in the frame's concatenated disk words,
// words[start_i : start_i + count_i]: the SW sync words, then each
// sub-block's live words (b plane groups of pw words, ceil(n_exc/4)
// position words, the exception value words) back to back. No staged
// 192-word slot is built: a sub-block's word offset is the exclusive scan
// of the live word counts its sync entries give (kernels/vertical.py
// region_word_counts). Each row un-transposes its planes below b, reads the
// exception values raw or un-planes them, and ORs v_j << b into the listed
// positions. Unlike the TPU kernel it also takes block_len % 128 != 0 (a
// short last sub with pw < 4 plane words).
//
// A block whose sync table has a width above 32, more than 16 exceptions in
// an entry, or word counts that do not add up to count_i is flagged in
// bad[i] and decodes nothing; no block reads past its count_i words.
//
// The slot form (SLOT) reads the reference's VERTICAL payload rows instead
// (dctpu/kernels/vertical_xla.py encode_vertical, the rows decode_blocks
// takes): row i at i * row_words, its SW sync words, then sub-block s's
// live words at the start of its 192-word slot, SW + 192 s. A sub's offset
// is its slot, not a scan; a row whose entries are malformed (as above) or
// whose live words would not fit their slot is flagged 1, and one with a
// width above max_planes, the reference's static bound on b, is flagged 2.
// Either decodes nothing.
//
// What bounds it on the card: it reads at most 148 words and writes 128 per
// 128-sample row, and un-transposes b planes; the bytes bound it, but a row
// that waits for its words in device memory waits longer than it takes to
// decode, and the un-transpose is most of its instructions. Design: a thread
// block per codec block and a warp per row, each warp walking rows warp,
// warp + 4, ...: no block barrier at all. Every warp scans the sync entries
// 32 at a time with shuffles (the entries of a block fit in one or two
// cache lines), so it knows each of its rows' word offsets. A row's live
// words are read coalesced by lane into the warp's 16-byte-aligned shared
// slot; the next row's words are loaded into registers while the current
// one decodes. Every lane reads the same plane word (a broadcast, all four
// of a full row's in one 16-byte read) and shifts its bit in from the top
// plane down, one shift and one OR per plane word; the <= 16 exception
// lanes patch the warp's row in shared memory (their positions are
// distinct in a valid frame), and the row leaves in one coalesced store.
#include "bitplane.cuh"

namespace dct {

constexpr int kVdecWarps = 4;        // rows in flight per codec block
constexpr int kRowLoads = (kRegionWords + 31) / 32;  // 5 loads per lane

struct Entry {
  int b;      // plane count
  int n_exc;  // exceptions
  int e;      // bit length of the largest exception value (0 if none)
  int words;  // live words of the row
};

__device__ __forceinline__ Entry parse_entry(uint32_t entry, int pw) {
  Entry r;
  r.b = entry & 63;
  r.n_exc = (entry >> 6) & 31;
  r.e = r.n_exc > 0 ? ((entry >> 11) & 31) + 1 : 0;
  const int vw = r.n_exc > 0 ? min(r.n_exc, (r.e + 1) >> 1) : 0;
  r.words = pw * r.b + ((r.n_exc + 3) >> 2) + vw;
  return r;
}

// v << 1 with bit `lane` of plane word q shifted in at the bottom
__device__ __forceinline__ uint32_t shift_in(uint32_t v, uint32_t q, int lane) {
  return (v << 1) | ((q >> lane) & 1u);
}

template <bool SLOT>
__global__ void __launch_bounds__(32 * kVdecWarps)
vdec_words_kernel(const uint32_t* __restrict__ words,
                  const int64_t* __restrict__ start,
                  const int32_t* __restrict__ count,
                  const int32_t* __restrict__ n, int32_t* __restrict__ z,
                  int32_t* __restrict__ bad, int block_len, int row_words,
                  int max_planes) {
  __shared__ __align__(16) uint32_t slot_sh[kVdecWarps][kRegionWords];
  __shared__ uint32_t row_sh[kVdecWarps][kSub];

  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* src =
      SLOT ? words + static_cast<size_t>(blk) * row_words : words + start[blk];
  const int cnt = SLOT ? row_words : count[blk];
  const int subs = (block_len + kSub - 1) / kSub;
  const int sync_words = (subs + 1) >> 1;
  uint32_t* slot = slot_sh[warp];
  uint32_t* row = row_sh[warp];

  // sync entry of sub s, zero where the block's words end
  auto entry_of = [&](int s) -> uint32_t {
    const int j = s >> 1;
    const uint32_t w = j < cnt ? src[j] : 0u;
    return (w >> (16 * (s & 1))) & 0xFFFFu;
  };

  // pass 1 (every warp): is the table well formed, and does it describe
  // exactly count_i words?
  int total = 0;
  bool ok = true, narrow = true;
  for (int s = lane; s < subs; s += 32) {
    const Entry r = parse_entry(entry_of(s), plane_words(s, block_len));
    ok = ok && r.b <= 32 && r.n_exc <= kExcCap && r.words <= kRegionPad;
    narrow = narrow && r.b <= max_planes;
    total += r.words;
  }
  total = __reduce_add_sync(kFull, total);
  const bool is_bad =
      !__all_sync(kFull, ok) || (!SLOT && sync_words + total != cnt);
  const int flag = is_bad ? 1 : (__all_sync(kFull, narrow) ? 0 : 2);
  if (threadIdx.x == 0) bad[blk] = flag;
  if (flag || warp >= subs) return;

  // pass 2: this warp's rows s = warp, warp + kVdecWarps, ...; the lanes
  // hold the entry and the word offset of sub 32 * chunk + lane
  int chunk = -1, carry = 0, chunk_total = 0;
  uint32_t my_entry = 0;
  int my_off = 0;
  auto enter_chunk = [&](int c) {  // warp-uniform; chunks advance by one
    carry += chunk_total;
    chunk = c;
    const int s = 32 * c + lane;
    my_entry = s < subs ? entry_of(s) : 0u;
    const int w = s < subs ? parse_entry(my_entry, plane_words(s, block_len)).words : 0;
    int incl = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    my_off = carry + incl - w;
    chunk_total = __shfl_sync(kFull, incl, 31);
  };
  // a row's entry and the offset of its words after the sync table
  auto row_of = [&](int s, Entry& r, int& off) {
    if constexpr (SLOT) {
      r = parse_entry(entry_of(s), plane_words(s, block_len));
      off = s * kRegionPad;
      return;
    }
    if ((s >> 5) != chunk) enter_chunk(s >> 5);
    r = parse_entry(__shfl_sync(kFull, my_entry, s & 31), plane_words(s, block_len));
    off = __shfl_sync(kFull, my_off, s & 31);
  };
  // a row's live words into registers, lane-coalesced, zeros after them
  uint32_t pre[kRowLoads];
  auto fetch = [&](const Entry& r, int off) {
    const uint32_t* p = src + sync_words + off;
#pragma unroll
    for (int i = 0; i < kRowLoads; ++i) {
      const int t = lane + 32 * i;
      pre[i] = t < r.words ? __ldg(p + t) : 0u;
    }
  };

  int s = warp;
  Entry cur;
  int off;
  row_of(s, cur, off);
  fetch(cur, off);
  const int nb = n[blk];
  int32_t* zrow = z + static_cast<size_t>(blk) * block_len;
  while (true) {
#pragma unroll
    for (int i = 0; i < kRowLoads; ++i) {
      const int t = lane + 32 * i;
      if (t < kRegionWords) slot[t] = pre[i];
    }
    const int next = s + kVdecWarps;
    Entry nxt;
    if (next < subs) {  // the next row's words load during this row's decode
      row_of(next, nxt, off);
      fetch(nxt, off);
    }
    __syncwarp();

    const int pw = plane_words(s, block_len);
    const int b = cur.b;
    uint32_t v[kWarps] = {0, 0, 0, 0};
    if (pw == kWarps) {  // a full row: plane p's four words in one read
      for (int p = b - 1; p >= 0; --p) {
        const uint4 q = reinterpret_cast<const uint4*>(slot)[p];
        v[0] = shift_in(v[0], q.x, lane);
        v[1] = shift_in(v[1], q.y, lane);
        v[2] = shift_in(v[2], q.z, lane);
        v[3] = shift_in(v[3], q.w, lane);
      }
    } else {
      for (int p = b - 1; p >= 0; --p) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (w < pw) v[w] = shift_in(v[w], slot[p * pw + w], lane);
      }
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) row[32 * w + lane] = v[w];
    __syncwarp();

    if (lane < cur.n_exc && b < 32) {
      const int t0 = pw * b;
      const int posw = (cur.n_exc + 3) >> 2;
      const uint32_t pos = (slot[t0 + (lane >> 2)] >> (8 * (lane & 3))) & 0xFFu;
      const uint32_t* vw = slot + t0 + posw;
      uint32_t val = 0;
      if (cur.n_exc <= (cur.e + 1) / 2) {
        val = vw[lane];  // raw layout
      } else {           // bit-planed: plane p is bits [16(p%2), +16) of word p/2
        for (int p = 0; p < cur.e; ++p)
          val |= ((vw[p >> 1] >> (16 * (p & 1) + lane)) & 1u) << p;
      }
      if (pos < kSub) row[pos] |= val << b;
    }
    __syncwarp();

#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int i = s * kSub + 32 * w + lane;
      if (i < block_len) zrow[i] = i < nb ? static_cast<int32_t>(row[32 * w + lane]) : 0;
    }
    if (next >= subs) break;
    __syncwarp();  // the slot and the row are rewritten next
    s = next;
    cur = nxt;
  }
}

}  // namespace dct

// words [W] the frame's payload words (int32 bit patterns), start [B] int64
// and count [B] int32 each block's words, n [B] -> z [B, L] zigzag values
// (zero past n) and bad [B] (1 where the sync table does not describe the
// block's words; such a block's z is not written).
extern "C" int dct_vdec_words(const void* words, const void* start,
                              const void* count, const void* n, void* z,
                              void* bad, int num_blocks, int block_len,
                              void* stream) {
  dct::vdec_words_kernel<false><<<static_cast<unsigned>(num_blocks),
                                  32 * dct::kVdecWarps, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(start),
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(n),
      static_cast<int32_t*>(z), static_cast<int32_t*>(bad), block_len, 0, 32);
  return static_cast<int>(cudaGetLastError());
}

// slot form: payload [B, row_words] the reference's VERTICAL rows (int32
// bit patterns, row_words >= SW + S * 192), n [B] -> z [B, L] as above and
// bad [B] (1: a malformed sync table, 2: a width above max_planes; such a
// block's z is not written).
extern "C" int dct_vdec_slots(const void* payload, const void* n, void* z,
                              void* bad, int num_blocks, int block_len,
                              int row_words, int max_planes, void* stream) {
  dct::vdec_words_kernel<true><<<static_cast<unsigned>(num_blocks),
                                 32 * dct::kVdecWarps, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(payload), nullptr, nullptr,
      static_cast<const int32_t*>(n), static_cast<int32_t*>(z),
      static_cast<int32_t*>(bad), block_len, row_words, max_planes);
  return static_cast<int>(cudaGetLastError());
}
