// Sanitizer self-test program for the port's host coder
// (csrc/gf_coder.cpp with csrc/host_crc32c.cpp), built and run by
// tests/test_torch_native_sanitizers.py under ASan+UBSan and TSan: the
// port's copy of ozone_tpu/native/gf_coder_selftest.cpp.
//
// Exercises every exported entry point with real shapes: GF(2^8)
// matrix-apply single, batched and multithreaded (the TSan-relevant path:
// the one-shot thread pool over independent stripes), and slice CRC32C
// with a partial tail slice. Checks that the multithreaded output equals
// the single-threaded one and that a decode round trip (XOR parity)
// restores the data. Exit 0 on success; a sanitizer aborts on any finding.
// A program, not a library: cuda_build.py never builds it.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
void gf_matrix_apply(const uint8_t*, int, int, const uint8_t*, uint8_t*,
                     int64_t);
void gf_matrix_apply_batch(const uint8_t*, int, int, const uint8_t*,
                           uint8_t*, int64_t, int64_t);
void gf_matrix_apply_batch_mt(const uint8_t*, int, int, const uint8_t*,
                              uint8_t*, int64_t, int64_t, int);
void crc32c_slices(const uint8_t*, int64_t, int64_t, uint32_t*);
int native_probe();
}

// GF(2^8) multiply (poly 0x11D, the ISA-L/reference field) for building
// the 32-byte nibble tables the kernel consumes.
static uint8_t gf_mul(uint8_t a, uint8_t b) {
  uint16_t r = 0, aa = a;
  while (b) {
    if (b & 1) r ^= aa;
    aa <<= 1;
    if (aa & 0x100) aa ^= 0x11D;
    b >>= 1;
  }
  return (uint8_t)r;
}

static void fill_tables(const uint8_t* matrix, int rows, int k,
                        std::vector<uint8_t>& tables) {
  tables.assign((size_t)rows * k * 32, 0);
  for (int r = 0; r < rows; ++r)
    for (int j = 0; j < k; ++j) {
      uint8_t c = matrix[r * k + j];
      uint8_t* tab = &tables[((size_t)r * k + j) * 32];
      for (int lo = 0; lo < 16; ++lo) tab[lo] = gf_mul(c, (uint8_t)lo);
      for (int hi = 0; hi < 16; ++hi)
        tab[16 + hi] = gf_mul(c, (uint8_t)(hi << 4));
    }
}

int main() {
  if (!native_probe()) return 2;
  const int k = 6, rows = 3;
  const int64_t n = 8192 + 13;  // odd tail exercises scalar cleanup
  const int64_t batch = 64;

  uint8_t matrix[rows * k];
  for (int r = 0; r < rows; ++r)
    for (int j = 0; j < k; ++j)
      matrix[r * k + j] = (uint8_t)(1 + r * 31 + j * 7);
  std::vector<uint8_t> tables;
  fill_tables(matrix, rows, k, tables);

  std::vector<uint8_t> data((size_t)batch * k * n);
  uint32_t seed = 0x1234567u;
  for (auto& b : data) {
    seed = seed * 1664525u + 1013904223u;
    b = (uint8_t)(seed >> 24);
  }

  // single-threaded reference vs multithreaded result
  std::vector<uint8_t> out1((size_t)batch * rows * n);
  std::vector<uint8_t> outN((size_t)batch * rows * n, 0xAA);
  gf_matrix_apply_batch(tables.data(), rows, k, data.data(), out1.data(),
                        n, batch);
  gf_matrix_apply_batch_mt(tables.data(), rows, k, data.data(),
                           outN.data(), n, batch, 8);
  if (memcmp(out1.data(), outN.data(), out1.size()) != 0) {
    fprintf(stderr, "mt/st parity mismatch\n");
    return 1;
  }

  // XOR round-trip: parity matrix of all-ones == XOR of the k units;
  // re-XORing parity with k-1 units must restore the remaining unit
  uint8_t ones[k];
  memset(ones, 1, sizeof(ones));
  std::vector<uint8_t> xtab;
  fill_tables(ones, 1, k, xtab);
  std::vector<uint8_t> xparity(n);
  gf_matrix_apply(xtab.data(), 1, k, data.data(), xparity.data(), n);
  std::vector<uint8_t> rebuilt(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t acc = xparity[i];
    for (int j = 1; j < k; ++j) acc ^= data[(size_t)j * n + i];
    rebuilt[i] = acc;
  }
  if (memcmp(rebuilt.data(), data.data(), n) != 0) {
    fprintf(stderr, "xor round-trip mismatch\n");
    return 1;
  }

  // slice CRCs incl. a short tail slice
  std::vector<uint32_t> crcs((n + 1023) / 1024);
  crc32c_slices(data.data(), n, 1024, crcs.data());
  if (crcs.back() == 0 && crcs.front() == 0) {
    fprintf(stderr, "implausible zero CRCs\n");
    return 1;
  }
  printf("selftest ok\n");
  return 0;
}
