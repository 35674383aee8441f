// The host feed: concatenated stream samples -> padded [B, L] blocks, their
// valid counts and 4-sample histories (the arrays of
// dctpu_torch/codec/api.py build_blocks_flat_plain, byte for byte).
//
// The port's own copy of the reference's native/host_transforms.cpp
// dctpu_build_blocks, the feed of millions of short streams: one memcpy per
// block and a memset of its tail, so that x needs no zeroing pass of its
// own. The reference runs its streams under OpenMP; the card machine's g++
// has no OpenMP runtime (libgomp), so here the streams are cut into runs of
// about equal block counts, one std::thread each.
//
// flat [total] int32; sstart [S + 1] int64 exclusive sample offsets; first
// [S] int64 each stream's first block; x [B, L], n [B], hist [B, 4] int32.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Samples of output a thread is worth starting for (4 MiB of x).
constexpr int64_t kSamplesPerThread = int64_t{1} << 20;

void build_streams(const int32_t* flat, const int64_t* sstart,
                   const int64_t* first, int64_t s0, int64_t s1, int64_t L,
                   int32_t* x, int32_t* n, int32_t* hist) {
  for (int64_t s = s0; s < s1; s++) {
    const int64_t len = sstart[s + 1] - sstart[s];
    const int64_t k = (len + L - 1) / L;
    const int32_t* src = flat + sstart[s];
    const int64_t f = first[s];
    for (int64_t b = 0; b < k; b++) {
      const int64_t off = b * L;
      const int64_t m = std::min(len - off, L);
      int32_t* row = x + (f + b) * L;
      std::memcpy(row, src + off, m * sizeof(int32_t));
      if (m < L) std::memset(row + m, 0, (L - m) * sizeof(int32_t));
      n[f + b] = static_cast<int32_t>(m);
      for (int j = 0; j < 4; j++) {
        const int64_t idx = off - 1 - j;
        hist[(f + b) * 4 + j] = idx >= 0 ? src[idx] : 0;
      }
    }
  }
}

}  // namespace

// num_blocks B; threads: the most threads to use (at least one per
// kSamplesPerThread samples of x is run).
extern "C" void dctpu_torch_build_blocks(const int32_t* flat,
                                         const int64_t* sstart,
                                         const int64_t* first, int64_t S,
                                         uint32_t L, int32_t* x, int32_t* n,
                                         int32_t* hist, int64_t num_blocks,
                                         int threads) {
  const int64_t T = std::max<int64_t>(
      1, std::min<int64_t>(threads, num_blocks * L / kSamplesPerThread));
  // run t takes the streams whose first block lies in [t B / T, (t+1) B / T)
  std::vector<int64_t> cut(T + 1, S);
  for (int64_t t = 0; t < T; t++)
    cut[t] = std::lower_bound(first, first + S, t * num_blocks / T) - first;
  cut[0] = 0;
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < T; t++)
    pool.emplace_back(build_streams, flat, sstart, first, cut[t], cut[t + 1],
                      int64_t{L}, x, n, hist);
  build_streams(flat, sstart, first, cut[0], cut[1], L, x, n, hist);
  for (auto& th : pool) th.join();
}
