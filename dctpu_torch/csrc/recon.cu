// R: reconstruction of decoded blocks, zigzag values -> samples (FORMAT §3).
//
// Replaces the tail of dctpu/codec/decode.py decode_blocks_body: unzigzag,
// the per-block predictor inverse (dctpu/codec/predict.py reconstruct_all:
// the two cumsums of DELTA and DOUBLE_DELTA, and the XLA lax.scan of
// reconstruct_lpc) and the zeros past n. It was no Pallas kernel on the TPU.
//
// What bounds it on the card: it reads 4 bytes and writes 4 bytes per
// sample (~0.08 ms at 8192 x 4096), and the LPC recurrence is a chain of L
// dependent steps per block (the Q16 floor shift is not associative, so it
// does not scan). Design: a lane per block, a warp per 32 blocks. DELTA and
// DOUBLE_DELTA run as the LPC recurrence with their exact Q16 tables
// (residual.cuh predictor_table), so every lane runs the same code whatever
// its block's predictor: no divergence, and all 32 lanes carry a chain. The
// warp streams its 32 blocks through shared memory in kChunk-sample pieces
// (512 contiguous bytes of each block per visit), double-buffered with
// cp.async: the next piece is in flight while lane b walks block b's
// samples of this one (x_{t-1..t-4} in registers) and writes the results
// back in place; the warp then stores the piece coalesced. A block writes
// zeros from n on; samples past n never feed earlier ones, so this equals
// the reference's reconstruct-then-mask.
#include "bitplane.cuh"
#include "residual.cuh"

namespace dct {

constexpr int kRows = 32;    // blocks per warp, one per lane
constexpr int kChunk = 128;  // samples of each block per piece
constexpr int kStride = kChunk + 1;  // odd: lane b's walk is conflict-free

// Starts the copies of the piece at sample base of the warp's blocks into
// buf, as one cp.async group. Samples past block_len and blocks past rows
// are not copied: they never reach device memory.
__device__ __forceinline__ void load_piece(int32_t (*buf)[kStride],
                                           const int32_t* zb, int rows,
                                           int block_len, int base) {
  const int lane = threadIdx.x;
  for (int q = 0; q < rows; ++q) {
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      const int col = base + 32 * k + lane;
      if (col < block_len)
        copy_async4(&buf[q][32 * k + lane],
                    zb + static_cast<size_t>(q) * block_len + col);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(32)
recon_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ n,
             const int32_t* __restrict__ predictor,
             const int32_t* __restrict__ table_idx,
             const int32_t* __restrict__ history,
             const int32_t* __restrict__ tables, int num_tables,
             int32_t* __restrict__ x, int num_blocks, int block_len) {
  __shared__ int32_t tile[2][kRows][kStride];  // [buffer][block][sample]

  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, num_blocks - row0);
  const int mine = row0 + lane;  // this lane's block

  Lpc c{0, 0, 0, 0};
  int32_t h0 = 0, h1 = 0, h2 = 0, h3 = 0;  // x_{t-1} .. x_{t-4}
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
    c = predictor_table(pred, lpc);
    const int32_t* h = history + 4 * static_cast<size_t>(mine);
    h0 = h[0];
    h1 = h[1];
    h2 = h[2];
    h3 = h[3];
  }

  const int32_t* zb = z + static_cast<size_t>(row0) * block_len;
  int32_t* xb = x + static_cast<size_t>(row0) * block_len;
  load_piece(tile[0], zb, rows, block_len, 0);
  for (int base = 0, b = 0; base < block_len; base += kChunk, b ^= 1) {
    if (base + kChunk < block_len)
      load_piece(tile[b ^ 1], zb, rows, block_len, base + kChunk);
    else
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group
    asm volatile("cp.async.wait_group 1;\n" ::);    // this piece has landed
    __syncwarp();

    int32_t* mrow = tile[b][lane];
    const int len = min(kChunk, block_len - base);
#pragma unroll 8
    for (int j = 0; j < len; ++j) {
      const uint32_t r = unzigzag(static_cast<uint32_t>(mrow[j]));
      const int32_t xt =
          static_cast<int32_t>(r + lpc_predict(c, h0, h1, h2, h3));
      mrow[j] = base + j < nb ? xt : 0;
      h3 = h2;
      h2 = h1;
      h1 = h0;
      h0 = xt;
    }
    __syncwarp();
    for (int q = 0; q < rows; ++q) {
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int col = base + 32 * k + lane;
        if (col < block_len)
          xb[static_cast<size_t>(q) * block_len + col] =
              tile[b][q][32 * k + lane];
      }
    }
    __syncwarp();  // the next piece but one is copied into this buffer
  }
}

}  // namespace dct

// z [B, L] zigzag values (int32 bit patterns), n, predictor, table_idx [B],
// history [B, 4], tables [T, 4] int32 Q16 coefficients -> x [B, L] int32
// samples (zero past n).
extern "C" int dct_reconstruct(const void* z, const void* n,
                               const void* predictor, const void* table_idx,
                               const void* history, const void* tables,
                               int num_tables, void* x, int num_blocks,
                               int block_len, void* stream) {
  const unsigned grid = (num_blocks + dct::kRows - 1) / dct::kRows;
  dct::recon_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(predictor),
      static_cast<const int32_t*>(table_idx),
      static_cast<const int32_t*>(history),
      static_cast<const int32_t*>(tables), num_tables,
      static_cast<int32_t*>(x), num_blocks, block_len);
  return static_cast<int>(cudaGetLastError());
}
