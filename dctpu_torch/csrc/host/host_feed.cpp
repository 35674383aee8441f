// The host feed: int32 stream samples -> padded [B, L] blocks, their valid
// counts and 4-sample histories (the arrays of
// dctpu_torch/codec/api.py build_blocks_flat_plain, byte for byte).
//
// The port's own copy of the reference's native/host_transforms.cpp
// dctpu_build_blocks, the feed of millions of short streams: one memcpy per
// block and a memset of its tail, so that x needs no zeroing pass of its
// own. The reference runs its streams under OpenMP; the card machine's g++
// has no OpenMP runtime (libgomp), so here the streams are cut into runs of
// about equal block counts, one std::thread each.
//
// The samples are read where they lie: stream s's lens[s] samples start at
// address addr[s], in the stream's own buffer or in one concatenation of
// them all. dctpu_torch_stream_addresses finds those addresses by one walk
// over the caller's tuple of streams, so that no Python code touches each
// stream and nothing is concatenated.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/ndarraytypes.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Samples of output a thread is worth starting for (4 MiB of x).
constexpr int64_t kSamplesPerThread = int64_t{1} << 20;

// A sample where a stream may lie unaligned (a cast stream keeps its buffer).
inline int32_t load(const int32_t* p) {
  int32_t v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

void build_streams(const int64_t* addr, const int64_t* lens,
                   const int64_t* first, int64_t s0, int64_t s1, int64_t L,
                   int32_t* x, int32_t* n, int32_t* hist) {
  for (int64_t s = s0; s < s1; s++) {
    const int64_t len = lens[s];
    const int64_t k = (len + L - 1) / L;
    const int32_t* src = reinterpret_cast<const int32_t*>(addr[s]);
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
        hist[(f + b) * 4 + j] = idx >= 0 ? load(src + idx) : 0;
      }
    }
  }
}

}  // namespace

// addr [S], lens [S], first [S] int64: each stream's samples, sample count
// and first block; x [B, L], n [B], hist [B, 4] int32; num_blocks B;
// threads: the most threads to use (at least one per kSamplesPerThread
// samples of x is run). Touches no Python object: bound without the GIL.
extern "C" void dctpu_torch_build_blocks(const int64_t* addr,
                                         const int64_t* lens,
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
    pool.emplace_back(build_streams, addr, lens, first, cut[t], cut[t + 1],
                      int64_t{L}, x, n, hist);
  build_streams(addr, lens, first, cut[0], cut[1], L, x, n, hist);
  for (auto& th : pool) th.join();
}

// One walk over a tuple of streams: for each item that can be read in place
// (exactly an ndarray, C-contiguous, aligned, native-endian int32, of any
// number of dimensions) its size and the address of its samples; for any
// other item lens[s] = -1 and addr[s] = 0, left for the caller to cast.
// Returns the number of items left, or -1 if items is not a tuple. Bound
// with the GIL held (ctypes.PyDLL); takes no references and keeps none, so
// the addresses hold while the caller holds the tuple.
extern "C" int64_t dctpu_torch_stream_addresses(PyObject* items,
                                                PyObject* ndarray,
                                                int64_t* lens, int64_t* addr) {
  if (!PyTuple_Check(items)) return -1;
  const Py_ssize_t S = PyTuple_GET_SIZE(items);
  const PyTypeObject* exact = reinterpret_cast<PyTypeObject*>(ndarray);
  constexpr int kInPlace = NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED;
  int64_t left = 0;
  for (Py_ssize_t s = 0; s < S; s++) {
    PyObject* item = PyTuple_GET_ITEM(items, s);
    if (Py_TYPE(item) == exact) {
      PyArrayObject* a = reinterpret_cast<PyArrayObject*>(item);
      if (PyArray_CHKFLAGS(a, kInPlace) && PyArray_TYPE(a) == NPY_INT32 &&
          PyArray_ISNBO(PyArray_DESCR(a)->byteorder)) {
        int64_t size = 1;
        for (int d = 0; d < PyArray_NDIM(a); d++) size *= PyArray_DIMS(a)[d];
        lens[s] = size;
        addr[s] = reinterpret_cast<int64_t>(PyArray_DATA(a));
        continue;
      }
    }
    lens[s] = -1;
    addr[s] = 0;
    left++;
  }
  return left;
}
