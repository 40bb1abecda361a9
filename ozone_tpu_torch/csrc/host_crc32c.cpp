// Host CRC32C (Castagnoli) on the SSE4.2 crc32 instruction, for the
// datanode's read check, the writers' partial-cell checksums and the
// replicated path's chunk checksums.
//
// A copy of `crc32c_hw`, `crc32c_slices` and `native_probe` from the
// reference's native coder (ozone_tpu/native/gf_coder.cpp), built on its
// own by ozone_tpu_torch/cuda_build.py with g++ -O3 -msse4.2. Without
// -msse4.2 the bitwise loop below is what compiles, and `native_probe`
// answers 0.
//
// Exposed through a plain C interface for ctypes.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// Hardware CRC32C with the standard init/xorout convention; `prev` is the
// finalized CRC of preceding data (0 for none), as zlib.crc32's.
uint32_t crc32c_hw(const uint8_t* data, int64_t n, uint32_t prev) {
  uint32_t state = prev ^ 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  int64_t i = 0;
  uint64_t s64 = state;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    memcpy(&chunk, data + i, 8);
    s64 = _mm_crc32_u64(s64, chunk);
  }
  state = (uint32_t)s64;
  for (; i < n; ++i) state = _mm_crc32_u8(state, data[i]);
#else
  // bitwise fallback (poly 0x82F63B78 reflected)
  for (int64_t i = 0; i < n; ++i) {
    state ^= data[i];
    for (int bit = 0; bit < 8; ++bit)
      state = (state >> 1) ^ (0x82F63B78u & (0u - (state & 1u)));
  }
#endif
  return state ^ 0xFFFFFFFFu;
}

// Slice-wise CRC32C over a buffer: one CRC per bpc bytes, the last slice
// as short as the buffer leaves it.
void crc32c_slices(const uint8_t* data, int64_t n, int64_t bpc,
                   uint32_t* out) {
  int64_t idx = 0;
  for (int64_t off = 0; off < n; off += bpc) {
    int64_t len = (off + bpc <= n) ? bpc : (n - off);
    out[idx++] = crc32c_hw(data + off, len, 0);
  }
}

// 2 with AVX2, 1 with SSE4.2 (the hardware CRC), 0 for the bitwise loop.
int native_probe() {
#if defined(__AVX2__)
  return 2;
#elif defined(__SSE4_2__)
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
