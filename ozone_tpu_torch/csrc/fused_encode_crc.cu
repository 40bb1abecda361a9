// Fused GF(2^8) matrix apply + per-slice CRC32/CRC32C for Hopper (sm_90a).
//
// Replaces ozone_tpu/codec/pallas_kernel.py:_make_kernel (the Pallas TPU
// kernel launched by _pallas_fused_cached) and the XLA program
// ozone_tpu/codec/fused.py:_fused_encode_cached.fn: a stripe batch
// data uint8 [B, k, C] and a coefficient matrix uint8 [p, k] give
//   out  uint8 [B, p, C]          out[b, i] = XOR_j matrix[i, j] * data[b, j]
//   crcs int32 [B, R, C / slice]  the CRC of every slice-byte piece of the
//                                 k input rows (crc_in) and the p output
//                                 rows (crc_out), inputs first.
// The matrix is a runtime argument, so the same kernel serves encode
// (Cauchy parity rows), decode (recovery rows, crc_in = 0) and re-encode.
// p = 0 with crc_in = 1 is a plain slice CRC.
//
// Bound: device memory traffic. The work reads B*k*C bytes, writes
// B*p*C bytes plus 4 bytes per CRC word; its arithmetic (p table lookups
// and one CRC table step per byte) is far below the card's rate. The
// design reads every input byte from device memory once: one block owns
// one (stripe, slice) and walks the slice in tiles of at most 4 KiB per
// row, staged in shared memory, where both the GF apply and the CRC of
// the inputs and of the freshly computed outputs read it. Outputs leave
// the block once, as 16-byte stores.
//
// GF apply: the p*k 256-byte product tables of the block's matrix are
// built in shared memory (4.5 KiB for RS(6,3), 20 KiB for RS(20,4)); a
// thread takes 4 byte positions at a time and XOR-accumulates the p
// outputs over the k inputs.
//
// CRC: a reflected CRC with zero initial state ("raw") is linear, and
// raw(A || B) = adv_|B|(raw(A)) ^ raw(B), where adv_L is the 32x32 GF(2)
// operator "advance through L zero bytes". Each lane takes raw of a
// 16-byte segment with the 1 KiB byte table, a warp folds its 32 segments
// (512 bytes) in five shuffle levels with adv_16 .. adv_256, and one
// thread per row carries the row state across 512-byte chunks and tiles
// with adv_512. Leading zero bytes leave a raw CRC unchanged, so a slice
// that is not a whole number of tiles is zero-padded at its front. The
// finalized CRC is raw(slice) ^ crc(0^slice) (init and xorout ~0). The
// table and the operators come from the host (codec/fused_kernel.py,
// built from utils/checksum._table).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 16;      // bytes of one lane's segment
constexpr int kChunk = 512;   // bytes one warp folds: 32 lanes * kSeg
constexpr int kLevels = 5;    // shuffle levels: adv_16 .. adv_256
constexpr int kMaxTile = 4096;
constexpr int kMaxP = 16;
constexpr int kConstWords = 256 + (kLevels + 1) * 32;  // table, then ops

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {
  int tile, ntiles, pad, rows, chunks;
  size_t state_off, chunk_off, data_off, out_off, gft_off, bytes;
};

__host__ __device__ inline Layout make_layout(int k, int p, int slice, int rows) {
  Layout l;
  l.tile = round_up(slice, kChunk);
  if (l.tile > kMaxTile) l.tile = kMaxTile;
  l.ntiles = (slice + l.tile - 1) / l.tile;
  l.pad = l.ntiles * l.tile - slice;
  l.rows = rows;
  l.chunks = l.tile / kChunk;
  l.state_off = kConstWords * 4;
  l.chunk_off = l.state_off + round_up(rows * 4, 16);
  l.data_off = l.chunk_off + round_up(rows * l.chunks * 4, 16);
  l.out_off = l.data_off + (size_t)k * l.tile;
  l.gft_off = l.out_off + (size_t)p * l.tile;
  l.bytes = l.gft_off + (size_t)p * k * 256;
  return l;
}

__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r ^= a & (0u - (b & 1u));
    b >>= 1;
    a <<= 1;
    a ^= 0x11Du & (0u - ((a >> 8) & 1u));  // x^8+x^4+x^3+x^2+1
  }
  return r;
}

// y = op * x over GF(2); op[i] is the image of bit i.
__device__ __forceinline__ uint32_t advance(const uint32_t* op, uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) y ^= op[i] & (0u - ((x >> i) & 1u));
  return y;
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t* tab, uint32_t crc, uint32_t w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) crc = (crc >> 8) ^ tab[(crc ^ (w >> (8 * i))) & 0xFFu];
  return crc;
}

__global__ void __launch_bounds__(kThreads)
fused_encode_crc_kernel(const uint8_t* __restrict__ data,
                        const uint8_t* __restrict__ matrix,
                        uint8_t* __restrict__ out,
                        int32_t* __restrict__ crcs,
                        const uint32_t* __restrict__ consts,
                        int k, int p, int cell, int slice, int crc_in,
                        int crc_out, uint32_t zeros_crc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (crc_in ? k : 0) + (crc_out ? p : 0);
  const Layout L = make_layout(k, p, slice, rows);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  const uint32_t* ops = tab + 256;
  uint32_t* state = reinterpret_cast<uint32_t*>(smem + L.state_off);
  uint32_t* chunk = reinterpret_cast<uint32_t*>(smem + L.chunk_off);
  uint8_t* sdata = smem + L.data_off;
  uint8_t* sout = smem + L.out_off;
  uint8_t* gft = smem + L.gft_off;

  const int tid = threadIdx.x;
  const int nslices = cell / slice;
  const int s = blockIdx.x % nslices;
  const long long b = blockIdx.x / nslices;
  const int tile = L.tile;

  for (int i = tid; i < kConstWords; i += blockDim.x) tab[i] = consts[i];
  for (int e = tid; e < p * k * 256; e += blockDim.x)
    gft[e] = static_cast<uint8_t>(gf_mul(matrix[e >> 8], e & 0xFF));
  for (int r = tid; r < rows; r += blockDim.x) state[r] = 0;
  __syncthreads();

  const uint8_t* din = data + (size_t)b * k * cell + (size_t)s * slice;
  uint8_t* dout = out + (size_t)b * p * cell + (size_t)s * slice;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int t = 0; t < L.ntiles; ++t) {
    const int v0 = t * tile - L.pad;  // slice offset of the tile's first byte
    // 1. stage the k input rows; bytes before the slice start are zeros
    if (vec) {
      const int q = tile / 16;
      for (int e = tid; e < k * q; e += blockDim.x) {
        const int j = e / q, c = e - j * q, off = v0 + c * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (off >= 0) v = *reinterpret_cast<const uint4*>(din + (size_t)j * cell + off);
        *reinterpret_cast<uint4*>(sdata + j * tile + c * 16) = v;
      }
    } else {
      for (int e = tid; e < k * tile; e += blockDim.x) {
        const int j = e / tile, off = v0 + (e - j * tile);
        sdata[e] = off >= 0 ? din[(size_t)j * cell + off] : 0;
      }
    }
    __syncthreads();

    // 2. GF(2^8) apply, 4 byte positions per thread per step
    if (p > 0) {
      for (int w = tid; w < tile / 4; w += blockDim.x) {
        uint32_t acc[kMaxP];
#pragma unroll
        for (int i = 0; i < kMaxP; ++i) acc[i] = 0;
        for (int j = 0; j < k; ++j) {
          const uint32_t x = reinterpret_cast<const uint32_t*>(sdata + j * tile)[w];
#pragma unroll
          for (int i = 0; i < kMaxP; ++i) {
            if (i < p) {
              const uint8_t* g = gft + (i * k + j) * 256;
              acc[i] ^= (uint32_t)g[x & 0xFF] | ((uint32_t)g[(x >> 8) & 0xFF] << 8) |
                        ((uint32_t)g[(x >> 16) & 0xFF] << 16) | ((uint32_t)g[x >> 24] << 24);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxP; ++i)
          if (i < p) reinterpret_cast<uint32_t*>(sout + i * tile)[w] = acc[i];
      }
      __syncthreads();

      // 3. write the outputs' real bytes
      if (vec) {
        const int q = tile / 16;
        for (int e = tid; e < p * q; e += blockDim.x) {
          const int i = e / q, c = e - i * q, off = v0 + c * 16;
          if (off >= 0)
            *reinterpret_cast<uint4*>(dout + (size_t)i * cell + off) =
                *reinterpret_cast<const uint4*>(sout + i * tile + c * 16);
        }
      } else {
        for (int e = tid; e < p * tile; e += blockDim.x) {
          const int i = e / tile, off = v0 + (e - i * tile);
          if (off >= 0) dout[(size_t)i * cell + off] = sout[e];
        }
      }
    }

    // 4. CRC: each warp folds one 512-byte chunk of one row at a time
    if (rows > 0) {
      for (int c = warp; c < rows * L.chunks; c += nwarps) {
        const int r = c / L.chunks, ch = c - r * L.chunks;
        const uint8_t* row = (crc_in && r < k) ? sdata + r * tile
                                                : sout + (r - (crc_in ? k : 0)) * tile;
        const uint4 v = *reinterpret_cast<const uint4*>(row + ch * kChunk + lane * kSeg);
        uint32_t crc = crc_word(tab, 0, v.x);
        crc = crc_word(tab, crc, v.y);
        crc = crc_word(tab, crc, v.z);
        crc = crc_word(tab, crc, v.w);
#pragma unroll
        for (int l = 0; l < kLevels; ++l) {
          const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, 1 << l);
          if ((lane & ((2 << l) - 1)) == 0) crc = advance(ops + l * 32, crc) ^ right;
        }
        if (lane == 0) chunk[c] = crc;
      }
      __syncthreads();
      for (int r = tid; r < rows; r += blockDim.x) {
        uint32_t st = state[r];
        for (int ch = 0; ch < L.chunks; ++ch)
          st = advance(ops + kLevels * 32, st) ^ chunk[r * L.chunks + ch];
        state[r] = st;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < rows; r += blockDim.x)
    crcs[((size_t)b * rows + r) * nslices + s] = static_cast<int32_t>(state[r] ^ zeros_crc);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). Sizes are
// validated by the Python wrapper; a shared-memory request beyond the
// card's limit comes back as the attribute call's error.
int fused_encode_crc(const void* data, const void* matrix, void* out, void* crcs,
                     const void* consts, int batch, int k, int p, int cell, int slice,
                     int crc_in, int crc_out, unsigned int zeros_crc, void* stream) {
  if (batch == 0) return 0;
  const int rows = (crc_in ? k : 0) + (crc_out ? p : 0);
  const Layout L = make_layout(k, p, slice, rows);
  const int vec = cell % 16 == 0 && slice % 16 == 0 && L.pad % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(fused_encode_crc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(batch) * (cell / slice);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_encode_crc_kernel<<<static_cast<unsigned>(blocks), kThreads, L.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(matrix),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(crcs),
      static_cast<const uint32_t*>(consts), k, p, cell, slice, crc_in, crc_out,
      zeros_crc, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_encode_crc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block of the kernel needs, in bytes.
long long fused_encode_crc_smem_bytes(int k, int p, int slice, int rows) {
  return static_cast<long long>(make_layout(k, p, slice, rows).bytes);
}

}  // extern "C"
