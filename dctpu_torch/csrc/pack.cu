// K5a: RICE bit packer, one payload row per block (FORMAT §2, §2.1).
//
// Replaces dctpu/kernels/attic/pack_pallas.py:72 _pack_kernel together with
// the XLA around it (the residuals and zigzag values of the block's chosen
// candidate and rice.codewords before it; the sync table and bit_len,
// which the TPU wrapper computed outside the kernel). Output row per block:
// the sync table (sub-block code bit lengths as u16 pairs), then the
// bitstream, each codeword at the bit offset given by the exclusive prefix
// sum of the code lengths before it, bit 0 = first stream bit, then zeros.
//
// Three forms, one template, by the source of the codewords: kX derives
// the residuals of the block's chosen candidate from the raw samples and
// the history with residual.cuh, the code of the selection kernels and of
// K3; kZ reads zigzag values; kCodes reads the codewords themselves, as
// the reference's kernels/api.pack takes them (code_lo, code_hi, length,
// valid per sample, the length of an invalid sample taken as 0), so that
// every sample, not only a prefix of n, may be left out.
//
// What bounds it on the card: it reads the block once (16 KiB at block_len
// 4096) and writes its padded row (24 KiB): bytes, once the integer work
// per codeword is small. The TPU kernel's prepend scan and merge pyramid
// existed because Mosaic has no dynamic-offset stores; here the costs to
// avoid are barriers, atomics and instructions per codeword. Design:
// eight warps per codec block, each taking sub-blocks w, w + 8, ..., a
// lane four consecutive samples of each, with a constant three block
// barriers:
//   1. each warp derives its sub-blocks' zigzag values and sums their code
//      lengths (one warp reduction per sub-block) into shared memory,
//      keeping the values of its first kKeep sub-blocks in registers;
//   2. warp 0 scans the sums into each sub-block's bit offset, and the
//      sync table and bit_len follow;
//   3. each warp packs its own sub-blocks: a shuffle scan of the lanes'
//      bit counts gives each lane its offset, and the lane appends its
//      four codewords through a 64-bit register buffer, storing each word
//      as it fills. Only a lane's first and last word, which the lanes
//      around it may share, take atomicOr.
// The row is built in shared memory, zeros included, and stored once with
// 16-byte stores where its length allows; a row larger than kSmemBytes
// (block_len above ~6600; FORMAT allows 65535) is zeroed and written in
// device memory instead. Sub-blocks past the kept ones (block_len above
// 4096) are derived again in pass 3, from L2.
#include <type_traits>

#include "bitplane.cuh"
#include "residual.cuh"

namespace dct {

enum class PackSrc { kZ, kX, kCodes };

// the largest row built in shared memory: 48 KiB less the static arrays
constexpr int kSmemBytes = 39 * 1024;
constexpr int kPackWarps = 8;
constexpr int kKeep = 4;  // sub-blocks a warp keeps in registers: L <= 4096

struct Code {
  uint64_t bits;  // bit 0 = first stream bit, at most 48 bits
  int len;
};

// The Rice codeword of u: q ones, a zero, the low k bits; an escape (q >=
// 16) is 16 ones, then the 32 raw bits.
__device__ __forceinline__ Code rice_code(uint32_t u, uint32_t kb) {
  const uint32_t q = u >> kb;
  if (q >= 16u) return {0xFFFFull | (static_cast<uint64_t>(u) << 16), 48};
  return {((1ull << q) - 1) |
              (static_cast<uint64_t>(u & ((1u << kb) - 1)) << (q + 1)),
          static_cast<int>(q + 1 + kb)};
}

// What a lane holds of a sample: its zigzag value, or in the kCodes form
// its codeword.
template <PackSrc S>
using Item = typename std::conditional<S == PackSrc::kCodes, Code, uint32_t>::type;

// The codeword of a sample, or none where it is not live.
__device__ __forceinline__ Code code_of(uint32_t z, uint32_t kb, bool live) {
  return live ? rice_code(z, kb) : Code{0, 0};
}
__device__ __forceinline__ Code code_of(const Code& c, uint32_t, bool live) {
  return live ? c : Code{0, 0};
}

// The kernel's inputs; each form reads its own.
struct PackIn {
  const int32_t* src;      // kZ: z [B, L]; kX: x [B, L]; kCodes: code_lo [B, L]
  const int32_t* hist;     // kX: [B, 4]
  const int32_t* n;        // kZ, kX: [B] valid counts
  const int32_t* k;        // kZ, kX: [B] Rice k
  const int32_t* choice;   // kX: [B] candidate of each block
  const int32_t* cands;    // kX: [C, 5] predictor and Q16 coefficients
  int num_cands;
  const int32_t* code_hi;  // kCodes: [B, L] bits 32.. of each codeword
  const int32_t* length;   // kCodes: [B, L] code lengths
  const uint8_t* valid;    // kCodes: [B, L] bool
};

// The items of samples base + 4 lane + i of a block (0 from nb on): a
// lane takes four consecutive samples. All 32 lanes call it. row is the
// block's first sample in the [B, L] inputs.
template <PackSrc S>
__device__ __forceinline__ void lane_items(Item<S> (&z)[4], const PackIn& in,
                                           size_t row, const int32_t* hist,
                                           int32_t* st, int base, int nb,
                                           int pred, const Lpc& lpc) {
  const int lane = threadIdx.x & 31;
  const int32_t* src = in.src + row;
  if constexpr (S == PackSrc::kCodes) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = base + 4 * lane + i;
      if (t < nb && in.valid[row + t]) {
        const uint64_t hi = static_cast<uint32_t>(in.code_hi[row + t]);
        z[i] = Code{static_cast<uint32_t>(src[t]) | (hi << 32),
                    in.length[row + t]};
      } else {
        z[i] = Code{0, 0};
      }
    }
  } else if constexpr (S == PackSrc::kX) {
    stage_row(st, src, hist, base, nb);
    // x_{base + 4 lane - 4} .. x_{base + 4 lane + 3}: two 16-byte reads
    const int4 a = reinterpret_cast<const int4*>(st)[lane];
    const int4 b = reinterpret_cast<const int4*>(st)[lane + 1];
    const int32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      z[i] = zigzag(static_cast<int32_t>(residual(pred, lpc, w, 4 + i)));
    __syncwarp();  // the next row rewrites st
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = base + 4 * lane + i;
      z[i] = t < nb ? static_cast<uint32_t>(src[t]) : 0u;
    }
  }
}

// Appends one lane's codewords to the stream from bit off on, a word at a
// time through a 64-bit register buffer. The lane's first and last words
// may hold codewords of the lanes (or sub-blocks) around it and take
// atomicOr; the words between are its alone and are stored. The row
// starts zeroed, so a zero needs no atomic.
struct BitWriter {
  uint32_t* stream;
  uint64_t acc;  // the bits not yet stored, the first at bit 0
  int nbits;     // how many: below 32 between appends
  int w;         // the stream word that acc's bit 0 belongs to
  bool first;    // w is the lane's first word

  __device__ __forceinline__ BitWriter(uint32_t* s, int off)
      : stream(s), acc(0), nbits(off & 31), w(off >> 5), first(true) {}

  __device__ __forceinline__ void put_word(uint32_t v, bool shared) {
    if (!shared) stream[w] = v;
    else if (v) atomicOr(stream + w, v);
  }

  // the low n <= 32 bits of v, whose bits from n on are 0
  __device__ __forceinline__ void append(uint32_t v, int n) {
    acc |= static_cast<uint64_t>(v) << nbits;
    nbits += n;
    if (nbits >= 32) {
      put_word(static_cast<uint32_t>(acc), first);
      first = false;
      ++w;
      acc >>= 32;
      nbits -= 32;
    }
  }

  __device__ __forceinline__ void append(const Code& c) {
    append(static_cast<uint32_t>(c.bits), min(c.len, 32));
    if (c.len > 32) append(static_cast<uint32_t>(c.bits >> 32), c.len - 32);
  }

  __device__ __forceinline__ void finish() {
    if (nbits > 0) put_word(static_cast<uint32_t>(acc), true);
  }
};

template <PackSrc S, bool SMEM>
__global__ void __launch_bounds__(kPackWarps * 32)
rice_pack_kernel(const PackIn in, int32_t* __restrict__ payload,
                 long long* __restrict__ bit_len, int block_len,
                 int row_words) {
  constexpr bool FROM_X = S == PackSrc::kX;
  extern __shared__ __align__(16) uint32_t smem_row[];
  __shared__ __align__(16) int32_t stage[kPackWarps][FROM_X ? 4 + kSub : 4];
  __shared__ int sub_bits[kMaxSubs];  // code bits of each sub-block
  __shared__ int sub_off[kMaxSubs];   // and its bit offset in the stream

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sync_words = (subs + 1) >> 1;
  uint32_t* out =
      reinterpret_cast<uint32_t*>(payload) + static_cast<size_t>(blk) * row_words;
  uint32_t* row = SMEM ? smem_row : out;
  // rows of a multiple of 4 words are 16-byte aligned: zeroed and copied
  // out 16 bytes at a time
  const bool wide = (row_words & 3) == 0;
  if (wide) {
    for (int t = tid; t < row_words >> 2; t += kPackWarps * 32)
      reinterpret_cast<uint4*>(row)[t] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int t = tid; t < row_words; t += kPackWarps * 32) row[t] = 0;
  }

  const size_t first = static_cast<size_t>(blk) * block_len;
  const int32_t* h = FROM_X ? in.hist + 4 * blk : nullptr;
  // the codes form's validity is per sample, in the codewords it reads
  const int nb = S == PackSrc::kCodes ? block_len
                                  : max(0, min(in.n[blk], block_len));
  // k <= 30 in a valid frame (FORMAT §2); the clamp only keeps shifts defined
  const uint32_t kb =
      S == PackSrc::kCodes ? 0u : min(static_cast<uint32_t>(in.k[blk]), 31u);
  int pred = kLpc;
  Lpc lpc{0, 0, 0, 0};
  if constexpr (FROM_X)
    chosen_candidate(in.cands, in.num_cands, in.choice[blk], pred, lpc);
  int32_t* st = stage[warp];
  uint32_t* stream = row + sync_words;

  auto derive = [&](int s, Item<S> (&z)[4]) {
    lane_items<S>(z, in, first, h, st, s * kSub, nb, pred, lpc);
  };
  // pass 1 on sub-block s: its code bits
  auto count = [&](int s, const Item<S> (&z)[4]) {
    int bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits += code_of(z[i], kb, s * kSub + 4 * lane + i < nb).len;
    bits = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(bits)));
    if (lane == 0) sub_bits[s] = bits;
  };
  // pass 2 on sub-block s: a lane's four codewords from the exclusive scan
  // of the lanes' bit counts on
  auto pack = [&](int s, const Item<S> (&z)[4]) {
    Code c[4];
    int bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = code_of(z[i], kb, s * kSub + 4 * lane + i < nb);
      bits += c[i].len;
    }
    int incl = bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    BitWriter writer(stream, sub_off[s] + incl - bits);
#pragma unroll
    for (int i = 0; i < 4; ++i) writer.append(c[i]);
    writer.finish();
  };

  // pass 1; the items of a warp's first kKeep sub-blocks stay in registers
  Item<S> kept[kKeep][4];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int s = warp + j * kPackWarps;
    if (s < subs) {
      derive(s, kept[j]);
      count(s, kept[j]);
    }
  }
  for (int s = warp + kKeep * kPackWarps; s < subs; s += kPackWarps) {
    Item<S> z[4];
    derive(s, z);
    count(s, z);
  }
  __syncthreads();

  // the sub-blocks' bit offsets: lane l of warp 0 scans a run of them
  if (warp == 0) {
    const int per = (subs + 31) >> 5;
    const int s0 = lane * per;
    int sum = 0;
    for (int j = 0; j < per; ++j)
      if (s0 + j < subs) sum += sub_bits[s0 + j];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    int run = incl - sum;
    for (int j = 0; j < per; ++j)
      if (s0 + j < subs) {
        sub_off[s0 + j] = run;
        run += sub_bits[s0 + j];
      }
    if (lane == 31) bit_len[blk] = incl;
  }
  __syncthreads();
  for (int t = tid; t < sync_words; t += kPackWarps * 32) {
    const uint32_t hi = 2 * t + 1 < subs ? sub_bits[2 * t + 1] : 0u;
    row[t] = static_cast<uint32_t>(sub_bits[2 * t]) | (hi << 16);
  }

  // pass 2, the later sub-blocks derived again
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int s = warp + j * kPackWarps;
    if (s < subs) pack(s, kept[j]);
  }
  for (int s = warp + kKeep * kPackWarps; s < subs; s += kPackWarps) {
    Item<S> z[4];
    derive(s, z);
    pack(s, z);
  }
  if constexpr (SMEM) {
    __syncthreads();
    if (wide) {
      for (int t = tid; t < row_words >> 2; t += kPackWarps * 32)
        reinterpret_cast<uint4*>(out)[t] = reinterpret_cast<const uint4*>(row)[t];
    } else {
      for (int t = tid; t < row_words; t += kPackWarps * 32) out[t] = row[t];
    }
  }
}

template <PackSrc S>
int launch_pack(const PackIn& in, void* payload, void* bit_len, int num_blocks,
                int block_len, int row_words, void* stream) {
  const size_t bytes = static_cast<size_t>(row_words) * sizeof(uint32_t);
  const bool in_smem = bytes <= static_cast<size_t>(kSmemBytes);
  const auto kernel = in_smem ? rice_pack_kernel<S, true>
                              : rice_pack_kernel<S, false>;
  kernel<<<num_blocks, kPackWarps * 32, in_smem ? bytes : 0,
           static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<int32_t*>(payload), static_cast<long long*>(bit_len),
      block_len, row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct

static const int32_t* i32(const void* p) {
  return static_cast<const int32_t*>(p);
}

// x form: x [B, L] raw int32 samples, hist [B, 4], n [B], k [B], choice [B]
// and cands [C, 5] (predictor, Q16 c0..c3 per candidate) -> payload
// [B, row_words] (sync table + bitstream + zeros), bit_len [B] int64.
extern "C" int dct_rice_pack_rows(const void* x, const void* hist,
                                  const void* n, const void* k,
                                  const void* choice, const void* cands,
                                  int num_cands, void* payload, void* bit_len,
                                  int num_blocks, int block_len, int row_words,
                                  void* stream) {
  const dct::PackIn in{i32(x), i32(hist), i32(n), i32(k), i32(choice),
                       i32(cands), num_cands, nullptr, nullptr, nullptr};
  return dct::launch_pack<dct::PackSrc::kX>(in, payload, bit_len, num_blocks,
                                        block_len, row_words, stream);
}

// z form: z [B, L] zigzag values (int32 bit patterns), k [B], n [B]
// -> payload, bit_len as above.
extern "C" int dct_rice_pack(const void* z, const void* k, const void* n,
                             void* payload, void* bit_len, int num_blocks,
                             int block_len, int row_words, void* stream) {
  const dct::PackIn in{i32(z), nullptr, i32(n), i32(k), nullptr, nullptr, 1,
                       nullptr, nullptr, nullptr};
  return dct::launch_pack<dct::PackSrc::kZ>(in, payload, bit_len, num_blocks,
                                        block_len, row_words, stream);
}

// codes form: code_lo, code_hi [B, L] (the codewords' bits 0..31 and 32..,
// int32 bit patterns; no bit set at or above a codeword's length), length
// [B, L] int32 and valid [B, L] bool -> payload, bit_len as above.
extern "C" int dct_rice_pack_codes(const void* code_lo, const void* code_hi,
                                   const void* length, const void* valid,
                                   void* payload, void* bit_len,
                                   int num_blocks, int block_len,
                                   int row_words, void* stream) {
  const dct::PackIn in{i32(code_lo), nullptr, nullptr, nullptr, nullptr,
                       nullptr, 1, i32(code_hi), i32(length),
                       static_cast<const uint8_t*>(valid)};
  return dct::launch_pack<dct::PackSrc::kCodes>(in, payload, bit_len, num_blocks,
                                            block_len, row_words, stream);
}
