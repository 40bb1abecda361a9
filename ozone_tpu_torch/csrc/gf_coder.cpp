// Host GF(2^8) erasure coder: the ISA-L-class CPU backend of the raw coder
// SPI (codec/cpp_coder.py), registered between the CUDA coder and numpy.
//
// The port's own copy of the nibble-table part of the reference's native
// coder (ozone_tpu/native/gf_coder.cpp): gf_mul_region_*, gf_matrix_apply,
// its batched and multithreaded forms, and a probe. A GF(2^8) multiply is
// the split-nibble table shuffle of ISA-L's gf_vect_mul (PSHUFB on the low
// and high nibbles against 16-entry product tables, the 32-byte
// per-coefficient layout of the reference's GF256.gfVectMulInit), with
// AVX2 when the compiler targets it. The CRC32C lives in host_crc32c.cpp.
//
// Built by ozone_tpu_torch/cuda_build.py with g++ -O3 -march=native
// -pthread; exposed through a plain C interface for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// Product tables: for coefficient c, lo[x] = mul(c, x) for x in 0..15 and
// hi[x] = mul(c, x << 4), built on the host (python) and passed in as
// tables[coef_index * 32].

static inline void gf_mul_region_scalar(const uint8_t* tab32,
                                        const uint8_t* src, uint8_t* dst,
                                        int64_t n) {
  const uint8_t* lo = tab32;
  const uint8_t* hi = tab32 + 16;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t b = src[i];
    dst[i] ^= (uint8_t)(lo[b & 0x0f] ^ hi[b >> 4]);
  }
}

#if defined(__AVX2__)
static inline void gf_mul_region_avx2(const uint8_t* tab32,
                                      const uint8_t* src, uint8_t* dst,
                                      int64_t n) {
  const __m128i lo128 = _mm_loadu_si128((const __m128i*)tab32);
  const __m128i hi128 = _mm_loadu_si128((const __m128i*)(tab32 + 16));
  const __m256i lo = _mm256_broadcastsi128_si256(lo128);
  const __m256i hi = _mm256_broadcastsi128_si256(hi128);
  const __m256i mask = _mm256_set1_epi8(0x0f);
  int64_t i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i vlo = _mm256_and_si256(v, mask);
    __m256i vhi = _mm256_and_si256(_mm256_srli_epi16(v, 4), mask);
    __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(lo, vlo),
                                    _mm256_shuffle_epi8(hi, vhi));
    __m256i d = _mm256_loadu_si256((const __m256i*)(dst + i));
    _mm256_storeu_si256((__m256i*)(dst + i), _mm256_xor_si256(d, prod));
  }
  if (i < n) gf_mul_region_scalar(tab32, src + i, dst + i, n - i);
}
#endif

static inline void gf_mul_region(const uint8_t* tab32, const uint8_t* src,
                                 uint8_t* dst, int64_t n) {
#if defined(__AVX2__)
  gf_mul_region_avx2(tab32, src, dst, n);
#else
  gf_mul_region_scalar(tab32, src, dst, n);
#endif
}

// Apply a coding matrix: out[r] = XOR_j mul(matrix[r*k+j], data[j]).
// tables: rows*k*32 bytes of per-coefficient nibble tables.
// data: k contiguous units of n bytes; out: rows units of n bytes (zeroed
// here).
void gf_matrix_apply(const uint8_t* tables, int rows, int k,
                     const uint8_t* data, uint8_t* out, int64_t n) {
  memset(out, 0, (size_t)rows * (size_t)n);
  for (int r = 0; r < rows; ++r) {
    uint8_t* o = out + (int64_t)r * n;
    for (int j = 0; j < k; ++j) {
      const uint8_t* tab = tables + ((int64_t)r * k + j) * 32;
      // a zero coefficient has all-zero tables and contributes nothing
      bool zero = true;
      for (int t = 0; t < 32; ++t)
        if (tab[t]) { zero = false; break; }
      if (zero) continue;
      gf_mul_region(tab, data + (int64_t)j * n, o, n);
    }
  }
}

// Batched variant: data [batch, k, n], out [batch, rows, n].
void gf_matrix_apply_batch(const uint8_t* tables, int rows, int k,
                           const uint8_t* data, uint8_t* out, int64_t n,
                           int64_t batch) {
  for (int64_t b = 0; b < batch; ++b) {
    gf_matrix_apply(tables, rows, k, data + b * k * n, out + b * rows * n, n);
  }
}

// Multithreaded batch: stripes are independent, so the batch splits
// across a one-shot pool of at most `threads` threads.
void gf_matrix_apply_batch_mt(const uint8_t* tables, int rows, int k,
                              const uint8_t* data, uint8_t* out, int64_t n,
                              int64_t batch, int threads) {
  int nt = (int)std::min<int64_t>(threads, batch);
  if (nt <= 1) {
    gf_matrix_apply_batch(tables, rows, k, data, out, n, batch);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)nt);
  const int64_t per = (batch + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = (int64_t)t * per;
    const int64_t hi = std::min<int64_t>(batch, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      gf_matrix_apply_batch(tables, rows, k, data + lo * k * n,
                            out + lo * rows * n, n, hi - lo);
    });
  }
  for (auto& th : pool) th.join();
}

// What the GF multiply compiled to: 2 with AVX2 (the nibble shuffle on
// 32-byte vectors), 0 for the scalar table loop.
int gf_coder_probe() {
#if defined(__AVX2__)
  return 2;
#else
  return 0;
#endif
}

}  // extern "C"
