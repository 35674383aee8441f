// Frame I/O on the host (dctpu_torch/format/frame.py): the frame's one
// output buffer, the directory and block-table rows written straight from
// their columns, the payload copy, and the sections' CRC-32; and the
// decode's copies of short streams out of its one flat download into their
// own arrays (codec/api.py). Each is cut over std::threads by the caller's
// thread count.
//
// The CRC is zlib's (IEEE 802.3, reflected, the value zlib.crc32 returns),
// in the source, since the card machine need not have zlib's headers: on an
// x86-64 CPU with PCLMULQDQ, 64 bytes a step folded by carry-less multiplies
// (Intel's "Fast CRC Computation for Generic Polynomials Using PCLMULQDQ",
// with the constants of Linux's crc32-pclmul_asm.S) and the last bytes by
// table; elsewhere table-driven, eight bytes a step. A section cut over T
// threads takes each piece's CRC on its own thread and joins them in order
// with zlib's crc32_combine method: the CRC of A then B is CRC(A) times
// x^(8 |B|) mod P, xor CRC(B), in GF(2).
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "rows are written in the host's byte order, which FORMAT fixes "
              "as little-endian");

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;  // x^32 + ... + 1, reflected

struct CrcTables {
  uint32_t t[8][256];
  uint32_t x2n[32];  // x^(2^n) mod P
  CrcTables();
};

// a(x) b(x) mod P, both reflected
uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = b & 1 ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

CrcTables::CrcTables() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = c & 1 ? (c >> 1) ^ kPoly : c >> 1;
    t[0][i] = c;
  }
  for (int k = 1; k < 8; k++)
    for (int i = 0; i < 256; i++)
      t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xff];
  uint32_t p = 1u << 30;  // x^1
  x2n[0] = p;
  for (int n = 1; n < 32; n++) x2n[n] = p = multmodp(p, p);
}

const CrcTables& tables() {
  static const CrcTables k;
  return k;
}

// the CRC register after p[0:n], from register c (not the CRC: ~CRC)
uint32_t crc_table(uint32_t c, const uint8_t* p, int64_t n) {
  const auto& t = tables().t;
  for (; n > 0 && reinterpret_cast<uintptr_t>(p) & 7; n--)
    c = t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= c;
    c = t[7][w & 0xff] ^ t[6][(w >> 8) & 0xff] ^ t[5][(w >> 16) & 0xff] ^
        t[4][(w >> 24) & 0xff] ^ t[3][(w >> 32) & 0xff] ^
        t[2][(w >> 40) & 0xff] ^ t[1][(w >> 48) & 0xff] ^ t[0][w >> 56];
  }
  for (; n > 0; n--) c = t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c;
}

#if defined(__x86_64__)
#define DCT_CLMUL __attribute__((target("pclmul,sse4.1")))

DCT_CLMUL inline __m128i fold16(__m128i x, __m128i k, __m128i next) {
  return _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x00),
                                     _mm_clmulepi64_si128(x, k, 0x11)),
                       next);
}

DCT_CLMUL inline __m128i load16(const uint8_t* p) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
}

// the register after p[0:n], n >= 64 and a multiple of 16
DCT_CLMUL uint32_t crc_clmul(uint32_t c, const uint8_t* p, int64_t n) {
  const __m128i k12 = _mm_set_epi64x(0x1c6e41596, 0x154442bd4);
  const __m128i k34 = _mm_set_epi64x(0x0ccaa009e, 0x1751997d0);
  const __m128i k5 = _mm_set_epi64x(0, 0x163cd6124);
  const __m128i poly = _mm_set_epi64x(0x1f7011641, 0x1db710641);  // u', P'
  const __m128i mask32 = _mm_set_epi32(0, 0, 0, -1);
  __m128i x1 = _mm_xor_si128(load16(p), _mm_cvtsi32_si128(static_cast<int>(c)));
  __m128i x2 = load16(p + 16), x3 = load16(p + 32), x4 = load16(p + 48);
  for (p += 64, n -= 64; n >= 64; p += 64, n -= 64) {
    x1 = fold16(x1, k12, load16(p));
    x2 = fold16(x2, k12, load16(p + 16));
    x3 = fold16(x3, k12, load16(p + 32));
    x4 = fold16(x4, k12, load16(p + 48));
  }
  x1 = fold16(fold16(fold16(x1, k34, x2), k34, x3), k34, x4);
  for (; n >= 16; p += 16, n -= 16) x1 = fold16(x1, k34, load16(p));
  // 128 bits to 64, then to 32, then Barrett's reduction
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), _mm_clmulepi64_si128(k34, x1, 0x01));
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 4),
                     _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), k5, 0x00));
  __m128i t = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x10);
  t = _mm_clmulepi64_si128(_mm_and_si128(t, mask32), poly, 0x00);
  return static_cast<uint32_t>(_mm_extract_epi32(_mm_xor_si128(x1, t), 1));
}

bool has_clmul() {
  static const bool k =
      __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
  return k;
}
#endif

uint32_t crc32(const uint8_t* p, int64_t n) {
  uint32_t c = ~0u;
#if defined(__x86_64__)
  if (n >= 64 && has_clmul()) {
    const int64_t m = n & ~int64_t{15};
    c = crc_clmul(c, p, m);
    p += m;
    n -= m;
  }
#endif
  return ~crc_table(c, p, n);
}

// the CRC of A then B, from CRC(A), CRC(B) and |B| bytes
uint32_t crc32_combine(uint32_t a, uint32_t b, int64_t len_b) {
  const auto& x2n = tables().x2n;
  uint32_t p = 1u << 31;  // x^0
  for (int k = 3; len_b; len_b >>= 1, k++)  // x^(8 len_b) = x^(len_b 2^3)
    if (len_b & 1) p = multmodp(x2n[k & 31], p);
  return multmodp(p, a) ^ b;
}

// run f(t, lo, hi) for t < T over [0, n) cut into T near-equal pieces, on
// T - 1 new threads and the caller's
template <typename F>
void cut(int64_t n, int threads, F f) {
  const int64_t T = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < T; t++)
    pool.emplace_back(f, t, n * t / T, n * (t + 1) / T);
  f(int64_t{0}, int64_t{0}, n / T);
  for (auto& th : pool) th.join();
}

struct DirRow {  // FORMAT §5 stream directory entry
  uint64_t stream_id;
  uint32_t cadence_s;
  uint32_t num_blocks;
  uint64_t num_samples;
  uint32_t first_block;
  uint32_t reserved;
};
static_assert(sizeof(DirRow) == 32 && offsetof(DirRow, first_block) == 24);

struct BlockRow {  // FORMAT §5 block header
  uint8_t predictor;
  uint8_t k;
  uint16_t n;
  uint32_t bit_len;
  uint8_t table_idx;
  uint8_t coder;
  uint8_t reserved[2];
  int32_t history[4];
  uint32_t reserved2;
};
static_assert(sizeof(BlockRow) == 32 && offsetof(BlockRow, history) == 12);

}  // namespace

// zlib.crc32 of p[0:n], cut over up to `threads` threads. Touches no Python
// object: bound without the GIL.
extern "C" uint32_t dctpu_torch_crc32(const uint8_t* p, int64_t n,
                                      int threads) {
  const int64_t T = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  std::vector<uint32_t> part(T);
  cut(n, static_cast<int>(T), [&](int64_t t, int64_t lo, int64_t hi) {
    part[t] = crc32(p + lo, hi - lo);
  });
  uint32_t c = part[0];
  for (int64_t t = 1; t < T; t++)
    c = crc32_combine(c, part[t], n * (t + 1) / T - n * t / T);
  return c;
}

// dst[0:n] = src[0:n], cut over up to `threads` threads. No GIL.
extern "C" void dctpu_torch_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                                 int threads) {
  cut(n, threads, [&](int64_t, int64_t lo, int64_t hi) {
    std::memcpy(dst + lo, src + lo, hi - lo);
  });
}

// For each of `streams` streams s, len[s] bytes from src + start[s] into
// the array at address dst[s]. The streams' bytes, laid end to end in
// stream order, are cut into near-equal pieces over up to `threads`
// threads; a thread finds the stream its piece starts in by binary search
// over the streams' ends there and copies the part of each stream in its
// piece to the same offset of that stream's array, so a stream across a
// cut is written by two threads at disjoint offsets. No GIL.
extern "C" void dctpu_torch_scatter(const uint8_t* src, int64_t streams,
                                    const int64_t* dst, const int64_t* start,
                                    const int64_t* len, int threads) {
  std::vector<int64_t> end(streams);
  int64_t n = 0;
  for (int64_t s = 0; s < streams; s++) end[s] = n += len[s];
  cut(n, threads, [&](int64_t, int64_t lo, int64_t hi) {
    for (int64_t s = std::upper_bound(end.begin(), end.end(), lo) - end.begin();
         s < streams && end[s] - len[s] < hi; s++) {
      const int64_t s0 = end[s] - len[s];
      const int64_t a = std::max(lo, s0) - s0, b = std::min(hi, end[s]) - s0;
      if (a < b)
        std::memcpy(reinterpret_cast<uint8_t*>(dst[s]) + a, src + start[s] + a,
                    b - a);
    }
  });
}

// The directory's rows [rows, 32 B] from its five columns, the reserved
// field zero. No GIL.
extern "C" void dctpu_torch_dir_rows(uint8_t* out, int64_t rows,
                                     const uint64_t* stream_id,
                                     const uint32_t* cadence_s,
                                     const uint32_t* num_blocks,
                                     const uint64_t* num_samples,
                                     const uint32_t* first_block,
                                     int threads) {
  cut(rows, threads, [&](int64_t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      const DirRow r{stream_id[i],   cadence_s[i],   num_blocks[i],
                     num_samples[i], first_block[i], 0};
      std::memcpy(out + i * sizeof r, &r, sizeof r);
    }
  });
}

// The block table's rows [rows, 32 B] from its seven columns (history
// [rows, 4]); coder 0 where `coder` is null, the reserved fields zero.
// No GIL.
extern "C" void dctpu_torch_block_rows(uint8_t* out, int64_t rows,
                                       const uint8_t* predictor,
                                       const uint8_t* k, const uint16_t* n,
                                       const uint32_t* bit_len,
                                       const uint8_t* table_idx,
                                       const uint8_t* coder,
                                       const int32_t* history, int threads) {
  cut(rows, threads, [&](int64_t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      BlockRow r{predictor[i], k[i], n[i], bit_len[i], table_idx[i],
                 coder ? coder[i] : uint8_t{0}, {0, 0}, {}, 0};
      std::memcpy(r.history, history + 4 * i, sizeof r.history);
      std::memcpy(out + i * sizeof r, &r, sizeof r);
    }
  });
}

// The directory's five columns from its rows [rows, 32 B], the reader's
// inverse of dctpu_torch_dir_rows. No GIL.
extern "C" void dctpu_torch_dir_columns(const uint8_t* in, int64_t rows,
                                        uint64_t* stream_id,
                                        uint32_t* cadence_s,
                                        uint32_t* num_blocks,
                                        uint64_t* num_samples,
                                        uint32_t* first_block, int threads) {
  cut(rows, threads, [&](int64_t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      DirRow r;
      std::memcpy(&r, in + i * sizeof r, sizeof r);
      stream_id[i] = r.stream_id;
      cadence_s[i] = r.cadence_s;
      num_blocks[i] = r.num_blocks;
      num_samples[i] = r.num_samples;
      first_block[i] = r.first_block;
    }
  });
}

// The block table's seven columns (history [rows, 4]) from its rows
// [rows, 32 B], the reader's inverse of dctpu_torch_block_rows. No GIL.
extern "C" void dctpu_torch_block_columns(const uint8_t* in, int64_t rows,
                                          uint8_t* predictor, uint8_t* k,
                                          uint16_t* n, uint32_t* bit_len,
                                          uint8_t* table_idx, uint8_t* coder,
                                          int32_t* history, int threads) {
  cut(rows, threads, [&](int64_t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      BlockRow r;
      std::memcpy(&r, in + i * sizeof r, sizeof r);
      predictor[i] = r.predictor;
      k[i] = r.k;
      n[i] = r.n;
      bit_len[i] = r.bit_len;
      table_idx[i] = r.table_idx;
      coder[i] = r.coder;
      std::memcpy(history + 4 * i, r.history, sizeof r.history);
    }
  });
}

// A new bytes object of n bytes, its contents unset, and the address of
// its first byte in *addr: the caller fills it before anyone else sees it.
// Bound with the GIL held (ctypes.PyDLL); returns a new reference, or null
// with the exception set.
extern "C" PyObject* dctpu_torch_new_bytes(int64_t n, int64_t* addr) {
  PyObject* b = PyBytes_FromStringAndSize(nullptr, n);
  if (b) *addr = reinterpret_cast<int64_t>(PyBytes_AS_STRING(b));
  return b;
}
