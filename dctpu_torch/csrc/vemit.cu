// K3: VERTICAL emission of whole blocks, straight into the payload rows.
//
// Replaces dctpu/kernels/vemit_pallas.py _vemit_kernel (vertical_emit_mega)
// and the XLA region assembly after it (dctpu/kernels/vertical_xla.py
// encode_vertical). Per block it writes the staged payload row: the sync
// words (entry b | n_exc << 6 | (e - 1) << 11 per sub-block, two u16 entries
// per word), then one kRegionPad-word slot per 128-sample sub-block with
// the pw * b plane words (plane p of word w at p * pw + w), ceil(n_exc / 4)
// position words (four u8 each), the exception values (raw when n_exc <=
// (e + 1) / 2, else bit-planed: plane p in bits [16 (p % 2), +16) of word
// p / 2), then zeros; and the block's bit_len, 32 x its live words. The
// width b is the FORMAT §2.2 min key (bitplane.cuh select_width).
//
// Two forms, one template: FROM_X derives the residuals of the block's
// chosen candidate from the raw samples and the history with residual.cuh,
// the code of the selection kernels; the other reads zigzag values.
//
// What bounds it on the card: it reads the block once (16 KiB at block_len
// 4096) and writes its row (~24 KiB): bytes. Design: a thread block of
// kEmitWarps warps per codec block; warp w takes rows w, w + kEmitWarps,
// ..., lane c holding samples 32 i + c. Per row: a bit-length histogram by
// shared-memory atomics, E by a shuffle suffix sum and the width rule in
// registers; the exceptions ranked by ballot prefix into shared memory;
// only the planes below b, by warp ballots; the slot assembled in the
// warp's shared tile, zeros included, and stored coalesced. The sync
// entries and the word total go through shared memory: one __syncthreads
// per block, no atomics across blocks, and no analysis array in device
// memory.
#include "bitplane.cuh"
#include "residual.cuh"

namespace dct {

constexpr int kEmitWarps = 4;

template <bool FROM_X>
__global__ void __launch_bounds__(kEmitWarps * 32)
vemit_rows_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ hist,
                  const int32_t* __restrict__ n,
                  const int32_t* __restrict__ choice,
                  const int32_t* __restrict__ cands, int num_cands,
                  int32_t* __restrict__ payload, int64_t* __restrict__ bit_len,
                  int block_len) {
  __shared__ int32_t stage[kEmitWarps][FROM_X ? 4 + kSub : 1];
  __shared__ int bins[kEmitWarps][32];  // the row's: bit length b at b - 1
  __shared__ uint32_t slot[kEmitWarps][kRegionPad];
  __shared__ uint32_t cpos[kEmitWarps][kExcCap];
  __shared__ uint32_t cval[kEmitWarps][kExcCap];
  __shared__ uint16_t entries[kMaxSubs];
  __shared__ int wsum[kEmitWarps];

  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int subs = (block_len + kSub - 1) / kSub;
  const int sync_words = (subs + 1) >> 1;
  const int nb = max(0, min(n[blk], block_len));
  const int32_t* row = src + static_cast<size_t>(blk) * block_len;
  uint32_t* out = reinterpret_cast<uint32_t*>(payload) +
                  static_cast<size_t>(blk) * (sync_words + subs * kRegionPad);

  int pred = kLpc;
  Lpc lpc{0, 0, 0, 0};
  if constexpr (FROM_X) chosen_candidate(cands, num_cands, choice[blk], pred, lpc);
  bins[warp][lane] = 0;
  __syncwarp();

  int words = 0;  // the live words of this warp's rows
  for (int s = warp; s < subs; s += kEmitWarps) {
    const int base = s * kSub;
    uint32_t z[kWarps];
    if constexpr (FROM_X) {
      int32_t* st = stage[warp];
      stage_row(st, row, hist + 4 * blk, base, nb);
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const uint32_t r = residual(pred, lpc, st, 4 + 32 * i + lane);
        const bool valid = base + 32 * i + lane < nb;
        z[i] = valid ? zigzag(static_cast<int32_t>(r)) : 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int t = base + 32 * i + lane;
        z[i] = t < nb ? static_cast<uint32_t>(row[t]) : 0u;
      }
    }

#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      if (z[i]) atomicAdd(&bins[warp][31 - __clz(static_cast<int>(z[i]))],
                          1);
    __syncwarp();
    const int here = bins[warp][lane];
    bins[warp][lane] = 0;
    const int pw = plane_words(s, block_len);
    const Width w = select_width(suffix_sum(here), pw);

    uint32_t* tile = slot[warp];
    for (int k = lane; k < kRegionPad; k += 32) tile[k] = 0u;
    // exceptions: the high bits z >> b, at their rank in position order
    int rank0 = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const uint32_t high = w.b >= 32 ? 0u : z[i] >> w.b;
      const unsigned m = __ballot_sync(kFull, high != 0u);
      const int rank = rank0 + __popc(m & ((1u << lane) - 1u));
      if (high != 0u && rank < kExcCap) {
        cpos[warp][rank] = 32 * i + lane;
        cval[warp][rank] = high;
      }
      rank0 += __popc(m);
    }
    __syncwarp();

    // planes below b: lane p keeps plane p of each 32-sample word
    uint32_t plane[kWarps] = {0u, 0u, 0u, 0u};
    for (int p = 0; p < w.b; ++p) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const uint32_t m = __ballot_sync(kFull, (z[i] >> p) & 1u);
        if (lane == p) plane[i] = m;
      }
    }
    if (lane < w.b) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i)
        if (i < pw) tile[lane * pw + i] = plane[i];
    }
    const int t0 = pw * w.b;
    const int posw = (w.n_exc + 3) >> 2;
    if (lane < posw) {
      uint32_t word = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * lane + q;
        if (j < w.n_exc) word |= cpos[warp][j] << (8 * q);
      }
      tile[t0 + lane] = word;
    }
    const uint32_t v = lane < w.n_exc ? cval[warp][lane] : 0u;
    uint32_t* vals = tile + t0 + posw;
    if (w.n_exc <= (w.e + 1) >> 1) {
      if (lane < w.n_exc) vals[lane] = v;
    } else {
      uint32_t word = 0u;
      for (int p = 0; p < w.e; ++p) {
        const uint32_t m = __ballot_sync(kFull, (v >> p) & 1u);
        if (lane == (p >> 1)) word |= m << (16 * (p & 1));
      }
      if (lane < (w.e + 1) >> 1) vals[lane] = word;
    }
    __syncwarp();

    uint32_t* dst = out + sync_words + static_cast<size_t>(s) * kRegionPad;
    for (int k = lane; k < kRegionPad; k += 32) dst[k] = tile[k];
    if (lane == 0) {
      const int e_field = w.n_exc > 0 ? w.e - 1 : 0;
      entries[s] =
          static_cast<uint16_t>(w.b | (w.n_exc << 6) | (e_field << 11));
      words += w.words;
    }
    __syncwarp();  // the next row rewrites stage, bins, the tile and cpos/cval
  }

  if (lane == 0) wsum[warp] = words;
  __syncthreads();
  for (int k = threadIdx.x; k < sync_words; k += kEmitWarps * 32) {
    const uint32_t hi = 2 * k + 1 < subs ? entries[2 * k + 1] : 0u;
    out[k] = entries[2 * k] | (hi << 16);
  }
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kEmitWarps; ++w) total += wsum[w];
    bit_len[blk] = 32LL * total;
  }
}

template <bool FROM_X>
int launch_rows(const void* src, const void* hist, const void* n,
                const void* choice, const void* cands, int num_cands,
                void* payload, void* bit_len, int num_blocks, int block_len,
                void* stream) {
  vemit_rows_kernel<FROM_X>
      <<<num_blocks, kEmitWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(src), static_cast<const int32_t*>(hist),
          static_cast<const int32_t*>(n), static_cast<const int32_t*>(choice),
          static_cast<const int32_t*>(cands), num_cands,
          static_cast<int32_t*>(payload), static_cast<int64_t*>(bit_len),
          block_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct

// x form: x [B, L] raw int32 samples, hist [B, 4], n [B], choice [B] and
// cands [C, 5] (predictor, Q16 c0..c3 per candidate) -> payload
// [B, SW + S * kRegionPad] int32 bit patterns, bit_len [B] int64.
extern "C" int dct_vemit_rows(const void* x, const void* hist, const void* n,
                              const void* choice, const void* cands,
                              int num_cands, void* payload, void* bit_len,
                              int num_blocks, int block_len, void* stream) {
  return dct::launch_rows<true>(x, hist, n, choice, cands, num_cands,
                                payload, bit_len, num_blocks, block_len,
                                stream);
}

// z form: z [B, L] zigzag values (int32 bit patterns), n [B] -> payload,
// bit_len as above.
extern "C" int dct_vemit_rows_z(const void* z, const void* n, void* payload,
                                void* bit_len, int num_blocks, int block_len,
                                void* stream) {
  return dct::launch_rows<false>(z, nullptr, n, nullptr, nullptr, 1,
                                 payload, bit_len, num_blocks, block_len,
                                 stream);
}
