// R: reconstruction of decoded blocks, zigzag values -> samples (FORMAT §3).
//
// Replaces the tail of dctpu/codec/decode.py decode_blocks_body: unzigzag,
// the per-block predictor inverse (dctpu/codec/predict.py reconstruct_all:
// the two cumsums of DELTA and DOUBLE_DELTA, and the XLA lax.scan of
// reconstruct_lpc) and the zeros past n. It was no Pallas kernel on the TPU.
// One launch covers a whole decode range: block b's zigzag row is row src[b]
// of the first coder group's z (src[b] >= 0) or row -1 - src[b] of the
// second's (src[b] < 0). R writes its output in one of two forms:
//
// - padded (out_off null): row b of [B, L] in block order, zeros past n
//   included, so the decode neither zero-fills nor scatters. Samples past n
//   never feed earlier ones, so writing zeros from n on equals the
//   reference's reconstruct-then-mask.
// - flat (out_off [B] int64): only block b's n valid samples, at x +
//   out_off[b], and no zeros. With out_off the prefix sum of n, the output
//   is the range's samples in stream order, which the host downloads as
//   they are.
//
// Only the mover's store address and limit tell the forms apart; the walk,
// the tiles and the pipeline are the same.
//
// What bounds it on the card: it reads 4 bytes and writes 4 bytes per
// sample (~0.08 ms at 8192 x 4096), and each block is a chain of L
// dependent steps (the Q16 floor shift is not associative, so the LPC
// recurrence does not scan). Design, for each:
//
// - The chain. A lane per block; DELTA and DOUBLE_DELTA run as the LPC
//   recurrence with their exact Q16 tables (residual.cuh predictor_table),
//   so every lane runs the same code whatever its predictor. x_{t-1} feeds
//   one wide multiply-add, acc = c0 x_{t-1} + q_t; the prediction is bits
//   16..47 of acc (the low word of acc >> 16: the shift's sign only reaches
//   bits 48 and up), one funnel shift, and x_t adds the residual to it.
//   q_t = c1 x_{t-2} + c2 x_{t-3} + c3 x_{t-4} is formed a step ahead, in
//   parallel with the chain; it wraps mod 2^64 as the sum in any order
//   does. The unzigzag of later residuals, the shared-memory reads and the
//   zero-past-n select of the stored value stay off the chain. In the SASS
//   (cuobjdump -sass; chip_smoke.py traces it) the chain is four
//   instructions: IMAD.WIDE c0 x_{t-1}, then IADD3 and IMAD.X add q_t
//   (ptxas splits the 64-bit addend off the IMAD.WIDE), then one LEA.HI
//   shifts by 16 and adds the residual. A step issues about 17
//   instructions, four of them IMAD.WIDE, and R's time is L such steps
//   of one warp whatever the batch (PERF.md §6).
// - The bytes. A CTA of two warps per 32 blocks: warp 0 walks, warp 1
//   moves. Each block's samples pass through shared memory in pieces of
//   kChunk; while the walker walks piece p, the mover stores piece p - 1
//   coalesced from its tile and starts the cp.async copies of piece p + 2,
//   so the walker's timeline holds no load or store phase. Three tile
//   buffers rotate between the two; a named barrier (bar.sync 1, 64) hands
//   them over once a piece. The tiles (50,688 bytes) are dynamic shared
//   memory.
#include "bitplane.cuh"
#include "residual.cuh"

namespace dct {

constexpr int kRows = 32;             // blocks per CTA, one per walker lane
constexpr int kChunk = 128;           // samples of each block per piece
constexpr int kStride = kChunk + 4;   // 16-byte rows; lane b's 16-byte reads
                                      // of row b are conflict-free
constexpr int kBufs = 3;              // walked, stored, loading
constexpr int kTileWords = kRows * kStride;
constexpr size_t kReconSmem = sizeof(int32_t) * kBufs * kTileWords;
constexpr int kMover = 1;  // warp 1 moves, warp 0 walks

__device__ __forceinline__ void handover() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async16(int32_t* smem, const int32_t* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// Mover: starts the copies of piece `base` of the CTA's rows into tile, as
// one cp.async group; lane q's my_z is row q's zigzag row. Samples past
// block_len are not copied.
__device__ __forceinline__ void load_piece(int32_t* tile, const int32_t* my_z,
                                           int rows, int block_len, int base,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < rows; ++q) {
    const int32_t* zrow = reinterpret_cast<const int32_t*>(__shfl_sync(
        kFull, reinterpret_cast<unsigned long long>(my_z), q));
    int32_t* trow = tile + q * kStride;
    if (vec) {  // block_len % 4 == 0: every 4-sample group is whole
      const int col = base + 4 * lane;
      if (col < block_len) copy_async16(trow + 4 * lane, zrow + col);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int col = base + 32 * k + lane;
        if (col < block_len) copy_async4(trow + 32 * k + lane, zrow + col);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Mover: stores piece `base` of the CTA's rows from tile, coalesced (the
// padded form: row q at xb + q * block_len, zeros past n included).
__device__ __forceinline__ void store_piece(const int32_t* tile,
                                            int32_t* xb, int rows,
                                            int block_len, int base,
                                            bool vec) {
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < rows; ++q) {
    const int32_t* trow = tile + q * kStride;
    int32_t* xrow = xb + static_cast<size_t>(q) * block_len;
    if (vec) {
      const int col = base + 4 * lane;
      if (col < block_len)
        *reinterpret_cast<int4*>(xrow + col) =
            *reinterpret_cast<const int4*>(trow + 4 * lane);
    } else {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int col = base + 32 * k + lane;
        if (col < block_len) xrow[col] = trow[32 * k + lane];
      }
    }
  }
}

// Mover: the flat form's store_piece: row q's samples base <= col < lim_q
// at x_q + col, x_q and lim_q (its n) read from the CTA's row table. A row
// whose x_q is 16-byte aligned takes 16-byte stores, with 4-byte ones for a
// last group of fewer than four samples; any other row 4-byte stores. The
// mover's time per piece is close to the walk's, so rows go four at a time:
// the table reads of one row overlap the stores of another.
__device__ __forceinline__ void store_piece_flat(const int32_t* tile,
                                                 int32_t* const* row_x,
                                                 const int* row_lim, int rows,
                                                 int base) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int q = 0; q < rows; ++q) {
    const int32_t* trow = tile + q * kStride;
    int32_t* xrow = row_x[q];
    const int lim = row_lim[q];
    if ((reinterpret_cast<uintptr_t>(xrow) & 15) == 0) {
      const int col = base + 4 * lane;
      if (col + 4 <= lim) {
        *reinterpret_cast<int4*>(xrow + col) =
            *reinterpret_cast<const int4*>(trow + 4 * lane);
      } else {
        for (int c = col; c < lim; ++c) xrow[c] = trow[c - base];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int col = base + 32 * k + lane;
        if (col < lim) xrow[col] = trow[32 * k + lane];
      }
    }
  }
}

// a * b + c: the exact signed 32 x 32 -> 64 product plus c, mod 2^64, as
// one IMAD.WIDE (nvcc builds int64 products of int32 operands from four
// 32-bit IMADs and an add)
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// One block's walk state: x_{t-1}, x_{t-2}, x_{t-3} and q_t.
struct Walk {
  Lpc c;
  int32_t h0, h1, h2;
  uint64_t q;

  // x_t from its unzigzagged residual r; the chain is the multiply-add and
  // the shift and add of the prediction (one LEA.HI)
  __device__ __forceinline__ int32_t step(uint32_t r) {
    const uint64_t acc = mad_wide(c.c0, h0, q);
    const uint32_t pred = __funnelshift_r(static_cast<uint32_t>(acc),
                                          static_cast<uint32_t>(acc >> 32), 16);
    const int32_t x = static_cast<int32_t>(pred + r);
    // q_{t+1} = c1 x_{t-1} + c2 x_{t-2} + c3 x_{t-3}, off the chain
    q = mad_wide(c.c1, h0, mad_wide(c.c2, h1, mad_wide(c.c3, h2, 0)));
    h2 = h1;
    h1 = h0;
    h0 = x;
    return x;
  }
};

__global__ void __launch_bounds__(64)
recon_kernel(const int32_t* __restrict__ za, const int32_t* __restrict__ zb,
             const int32_t* __restrict__ src, const int32_t* __restrict__ n,
             const int32_t* __restrict__ predictor,
             const int32_t* __restrict__ table_idx,
             const int32_t* __restrict__ history,
             const int32_t* __restrict__ tables, int num_tables,
             int32_t* __restrict__ x,
             const int64_t* __restrict__ out_off, int num_blocks,
             int block_len, bool vec) {
  extern __shared__ __align__(16) int32_t tiles[];  // [kBufs][kRows][kStride]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, num_blocks - row0);
  const int mine = row0 + lane;  // lane's block
  const int pieces = (block_len + kChunk - 1) / kChunk;

  if (warp == kMover) {
    // the flat form's row table: row q's output and its n
    __shared__ int32_t* row_x[kRows];
    __shared__ int row_lim[kRows];
    const bool flat = out_off != nullptr;
    const int32_t* my_z = za;
    if (lane < rows) {
      const int s = src ? src[mine] : mine;
      my_z = s >= 0 ? za + static_cast<size_t>(s) * block_len
                    : zb + static_cast<size_t>(-1 - s) * block_len;
      if (flat) {
        row_x[lane] = x + out_off[mine];
        row_lim[lane] = max(0, min(n[mine], block_len));
      }
    }
    __syncwarp();
    int32_t* xb = flat ? x : x + static_cast<size_t>(row0) * block_len;
    load_piece(tiles, my_z, rows, block_len, 0, vec);
    if (pieces > 1)
      load_piece(tiles + kTileWords, my_z, rows, block_len, kChunk, vec);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // piece 0 landed
    handover();
    for (int p = 0; p < pieces; ++p) {
      // the walker walks piece p; piece p - 1 is done with, and its buffer
      // takes piece p + 2 once it is stored
      if (p >= 1 && flat)
        store_piece_flat(tiles + (p - 1) % kBufs * kTileWords, row_x,
                         row_lim, rows, (p - 1) * kChunk);
      else if (p >= 1)
        store_piece(tiles + (p - 1) % kBufs * kTileWords, xb, rows,
                    block_len, (p - 1) * kChunk, vec);
      __syncwarp();
      if (p + 2 < pieces)
        load_piece(tiles + (p + 2) % kBufs * kTileWords, my_z, rows,
                   block_len, (p + 2) * kChunk, vec);
      else
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // p + 1 landed
      handover();
    }
    if (flat)
      store_piece_flat(tiles + (pieces - 1) % kBufs * kTileWords, row_x,
                       row_lim, rows, (pieces - 1) * kChunk);
    else
      store_piece(tiles + (pieces - 1) % kBufs * kTileWords, xb, rows,
                  block_len, (pieces - 1) * kChunk, vec);
    return;
  }

  // walker: lanes past rows walk garbage that is never stored
  Walk w{{0, 0, 0, 0}, 0, 0, 0, 0};
  int nb = 0;
  if (lane < rows) {
    nb = max(0, min(n[mine], block_len));
    const int pred = predictor[mine];
    Lpc lpc{0, 0, 0, 0};
    if (pred == kLpc) {
      // api._check_block_table rejects such frames; the clamp only keeps a
      // malformed index inside the table
      const int ti = min(max(table_idx[mine], 0), num_tables - 1);
      const int32_t* t = tables + 4 * ti;
      lpc = Lpc{t[0], t[1], t[2], t[3]};
    }
    w.c = predictor_table(pred, lpc);
    const int32_t* h = history + 4 * static_cast<size_t>(mine);
    w.h0 = h[0];  // x_{-1}
    w.h1 = h[1];
    w.h2 = h[2];
    w.q = mad_wide(w.c.c1, h[1],
                   mad_wide(w.c.c2, h[2], mad_wide(w.c.c3, h[3], 0)));
  }
  handover();  // piece 0 has landed
  for (int p = 0; p < pieces; ++p) {
    const int base = p * kChunk;
    int32_t* row = tiles + p % kBufs * kTileWords + lane * kStride;
    const int len = min(kChunk, block_len - base);
    const int valid = nb - base;  // samples j < valid are kept
#pragma unroll 4
    for (int j = 0; j < len; j += 4) {
      const int4 zz = *reinterpret_cast<const int4*>(row + j);
      const uint32_t r0 = unzigzag(static_cast<uint32_t>(zz.x));
      const uint32_t r1 = unzigzag(static_cast<uint32_t>(zz.y));
      const uint32_t r2 = unzigzag(static_cast<uint32_t>(zz.z));
      const uint32_t r3 = unzigzag(static_cast<uint32_t>(zz.w));
      int4 out;
      out.x = w.step(r0);
      out.y = w.step(r1);
      out.z = w.step(r2);
      out.w = w.step(r3);
      out.x = j < valid ? out.x : 0;
      out.y = j + 1 < valid ? out.y : 0;
      out.z = j + 2 < valid ? out.z : 0;
      out.w = j + 3 < valid ? out.w : 0;
      *reinterpret_cast<int4*>(row + j) = out;
    }
    handover();  // piece p is walked, p + 1 has landed
  }
}

}  // namespace dct

// za [Ba, L] and zb [Bb, L] zigzag values (int32 bit patterns; zb may be
// null), src [B] each block's row (>= 0: row of za; < 0: row -1 - src of
// zb; null: row b of za), n, predictor, table_idx [B], history [B, 4],
// tables [T, 4] int32 Q16 coefficients -> x int32 samples: with out_off
// null, [B, L], zero past n; else block b's n valid samples at x +
// out_off[b] (out_off [B] int64), nothing else written.
extern "C" int dct_reconstruct(const void* za, const void* zb, const void* src,
                               const void* n, const void* predictor,
                               const void* table_idx, const void* history,
                               const void* tables, int num_tables, void* x,
                               const void* out_off, int num_blocks,
                               int block_len, void* stream) {
  const unsigned grid = (num_blocks + dct::kRows - 1) / dct::kRows;
  // 16-byte loads (and the padded form's stores) where every row is aligned;
  // the flat form picks its stores row by row
  const uintptr_t addr = reinterpret_cast<uintptr_t>(za) |
                         reinterpret_cast<uintptr_t>(zb) |
                         (out_off ? 0 : reinterpret_cast<uintptr_t>(x));
  const bool vec = block_len % 4 == 0 && addr % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      dct::recon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dct::kReconSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dct::recon_kernel<<<grid, 64, dct::kReconSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(za), static_cast<const int32_t*>(zb),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(predictor),
      static_cast<const int32_t*>(table_idx),
      static_cast<const int32_t*>(history),
      static_cast<const int32_t*>(tables), num_tables,
      static_cast<int32_t*>(x), static_cast<const int64_t*>(out_off),
      num_blocks, block_len, vec);
  return static_cast<int>(cudaGetLastError());
}
