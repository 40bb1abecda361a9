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
// Bound of the work: device memory traffic. It reads B*k*C bytes and
// writes B*p*C bytes plus 4 bytes per CRC word. One block owns one
// (stripe, slice) and walks the slice in tiles of at most 4 KiB per row,
// staged once in shared memory with 16-byte cp.async copies; the GF apply
// and the CRCs of the inputs and of the fresh outputs all read the tile
// there, and the outputs leave the block once, as 16-byte stores. A block
// has a warp for every CRC row (8 to 16 warps), so the CRC phase of a
// tile is one round. What keeps the kernel from the byte bound is its
// integer instruction rate and its shared-memory wavefronts, so the design
// counts both.
//
// Tile layout. A tile of `tile` bytes per row is cut into 32 lane pieces
// of tile/32 bytes (16 .. 128). Piece l of a row sits at l * pitch in
// shared memory, where pitch pads the piece to an odd number of 16-byte
// units (128 -> 144), so the 32 lanes reading 16 bytes of their own
// pieces hit distinct banks in every quarter-warp.
//
// GF apply, in registers. A thread takes 16 byte positions (a uint4) of
// every row and runs Horner's rule over the coefficient bits:
//   acc_i = xtime(acc_i) ^ XOR_j (x_j & mask[j][b][i]),  b = 7 .. 0,
// where xtime doubles four packed bytes mod 0x11D,
//   ((x & 0x7f7f7f7f) << 1) ^ (((x >> 7) & 0x01010101) * 0x1d),
// computed as ((x << 1) & 0xfefefefe) ^ umulhi(x & 0x80808080, 0x1d << 25),
// and mask[j][b][i] is all ones when bit b of matrix[i][j] is set. The
// masks (k * 8 * round_up(p, 4) words, built per block from `matrix`)
// are read as uniform broadcasts; no lookup table and no data-dependent
// shared-memory address is left on the coding path. Horner doubles the p
// accumulators, 7p xtimes per position, where forming x_j * 2^b doubles
// the k inputs, 7k: for RS(6,3) that is 21 xtimes against 42. For k = 6
// (RS(6,3) and its decodes), the width measured faster that way, the k
// inputs stay in registers across the 8 bit steps; any other k reads them
// from shared memory at every step.
//
// CRC, one fold per slice. A reflected CRC from a zero state ("raw") is
// linear: raw(A || B) = adv_|B|(raw(A)) ^ raw(B), where adv_L is the
// 32x32 GF(2) operator "advance through L zero bytes". A warp owns one
// (row, slice) at a time; lane l runs a slicing-by-4 table CRC through
// piece l of each tile, continuing from its own state, which it first
// advances once across the other lanes' bytes (adv_{tile - tile/32}, by
// four 256-entry tables each block builds from that operator).
// At the end of the slice the 32 lane states fold once, in five shuffle
// levels with adv_{tile/32} .. adv_{16 tile/32}, and zeros_crc = crc(0^n)
// (init and xorout ~0) is XORed in. Leading zero bytes leave a raw CRC
// unchanged, so a slice that is not a whole number of tiles is zero-
// padded at its front. That is 3 + 5 advances per 16 KiB row slice,
// where folding each 512-byte chunk and carrying a row state across
// chunks takes 192, and no single-thread phase. The byte
// table and the six operators come from the host (codec/fused_kernel.py
// kernel_constants, built from utils/checksum._table); the three other
// slicing tables are derived from the byte table in each block and kept
// in static shared memory, so a lookup is a shift, a mask and a load.
//
// Cost per input byte, RS(6,3), 4 KiB tiles, reckoned from the source in
// thread instructions: GF ~10 (per 16 positions of all rows, 21 xtimes of
// 4 words at 4 each and 8 * k * p = 144 LOP3 of 4 words, plus 48 uniform
// mask loads, over 96 input bytes); CRC ~5 (a 4-byte word costs ~10
// integer operations and 4 table loads, 1.5 row bytes per input byte);
// staging and stores ~0.5. At Hopper's 64 integer operations per SM per
// clock that is ~0.9 TB/s of input on 132 SMs. Shared memory is the other
// limit: the table loads of 32 lanes land on random banks, ~3.5
// wavefronts each, which makes the CRC's 4 loads per word cost more
// wavefronts than the whole GF apply.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinWarps = 8;   // 256 threads: one per 16-byte position of a 4 KiB tile
constexpr int kMaxWarps = 16;
constexpr int kLanes = 32;
constexpr int kLevels = 5;                             // shuffle levels
constexpr int kOps = kLevels + 1;                      // gap advance, then folds
constexpr int kMinTile = kLanes * 16;                  // 16 bytes a lane
constexpr int kMaxTile = 4096;
constexpr int kMaxP = 16;
constexpr int kOpsBytes = kOps * 32 * 4;
constexpr int kTabWords = 4 * 256;  // slicing-by-4 byte tables
// Static shared memory: the slicing tables, the host byte table and the
// gap operator's four byte tables.
constexpr int kStaticBytes = (kTabWords + 256 + 1024) * 4;
static_assert(kMaxTile / 16 <= kMinWarps * 32, "a thread owns one 16-byte position per row");

// Threads of a block: a warp for every CRC row, so that the CRC phase
// takes one round (up to 16 rows), and at least one thread per 16-byte
// position. Instances with more than 4 output rows need more registers
// than 512 threads leave and keep 256.
constexpr int max_threads(int kP, int kK) {
  return kP > 4 ? kMinWarps * 32
                : (kK > 0 && kK + kP < kMaxWarps ? 32 * (kK + kP < kMinWarps ? kMinWarps : kK + kP)
                                                 : kMaxWarps * 32);
}

// Blocks per SM each instance is compiled for (it caps registers): 4 for
// RS(6,3) and narrower, whose shared memory allows 4.
constexpr int min_blocks(int kP, int kK) {
  return kP > 4 ? 1 : (kK > 0 && kK + kP <= 9 ? 4 : 2);
}

inline int block_threads(int rows, int p) {
  if (p > 4) return kMinWarps * 32;
  return 32 * (rows < kMinWarps ? kMinWarps : (rows > kMaxWarps ? kMaxWarps : rows));
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Output rows a kernel instance holds in registers: p itself up to 4,
// then 8 or 16 (unused rows carry zero masks and are never stored).
__host__ __device__ inline int p_bucket(int p) { return p <= 4 ? p : (p <= 8 ? 8 : kMaxP); }

struct Layout {
  int tile, piece, pitch, row_bytes, ntiles, pad, mask_stride;
  size_t mask_off, state_off, data_off, out_off, bytes;  // ops at offset 0
};

__host__ __device__ inline Layout make_layout(int k, int p, int slice, int rows) {
  Layout l;
  l.tile = round_up(slice, kMinTile);
  if (l.tile > kMaxTile) l.tile = kMaxTile;
  l.piece = l.tile / kLanes;
  l.pitch = (l.piece / 16) % 2 ? l.piece : l.piece + 16;
  l.row_bytes = kLanes * l.pitch;
  l.ntiles = (slice + l.tile - 1) / l.tile;
  l.pad = l.ntiles * l.tile - slice;
  l.mask_stride = p > 0 ? round_up(p_bucket(p), 4) : 0;
  l.mask_off = kOpsBytes;
  l.state_off = l.mask_off + (size_t)k * 8 * l.mask_stride * 4;
  l.data_off = l.state_off + (size_t)rows * kLanes * 4;
  l.out_off = l.data_off + (size_t)k * l.row_bytes;
  l.bytes = l.out_off + (size_t)p * l.row_bytes;
  return l;
}

// Doubles four packed GF(2^8) bytes mod 0x11D. The high bits h = x &
// 0x80808080 sit 8 apart, so h * 0x1d has no carries between bytes and
// umulhi(h, 0x1d << 25) = (h >> 7) * 0x1d: four instructions.
__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x << 1) & 0xFEFEFEFEu) ^ __umulhi(x & 0x80808080u, 0x3A000000u);
}

__device__ __forceinline__ uint4 xtime4(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

__device__ __forceinline__ void mac(uint4& acc, const uint4 x, uint32_t m) {
  acc.x ^= x.x & m;
  acc.y ^= x.y & m;
  acc.z ^= x.z & m;
  acc.w ^= x.w & m;
}

// acc[i] ^= x & m[i] for the kP outputs; m is a uniform mask row.
template <int kP, int kS>
__device__ __forceinline__ void mac_row(uint4 (&acc)[kP], const uint4 x, const uint32_t* m) {
#pragma unroll
  for (int i0 = 0; i0 < kS; i0 += 4) {
    const uint4 mm = *reinterpret_cast<const uint4*>(m + i0);
    if (i0 + 0 < kP) mac(acc[i0 + 0], x, mm.x);
    if (i0 + 1 < kP) mac(acc[i0 + 1], x, mm.y);
    if (i0 + 2 < kP) mac(acc[i0 + 2], x, mm.z);
    if (i0 + 3 < kP) mac(acc[i0 + 3], x, mm.w);
  }
}

// y = op * x over GF(2); op[i] is the image of bit i (uniform reads).
__device__ __forceinline__ uint32_t advance(const uint32_t* op, uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const uint4 o = *reinterpret_cast<const uint4*>(op + i);
    y ^= o.x & static_cast<uint32_t>(static_cast<int32_t>(x << (31 - i)) >> 31);
    y ^= o.y & static_cast<uint32_t>(static_cast<int32_t>(x << (30 - i)) >> 31);
    y ^= o.z & static_cast<uint32_t>(static_cast<int32_t>(x << (29 - i)) >> 31);
    y ^= o.w & static_cast<uint32_t>(static_cast<int32_t>(x << (28 - i)) >> 31);
  }
  return y;
}

// y = op * x by four 256-entry tables: g[n][v] = op applied to byte v at
// byte position n.
__device__ __forceinline__ uint32_t advance_tab(const uint32_t* g, uint32_t x) {
  return g[x & 0xFFu] ^ g[256 + ((x >> 8) & 0xFFu)] ^ g[512 + ((x >> 16) & 0xFFu)] ^
         g[768 + (x >> 24)];
}

// Four CRC bytes at once: tab holds T0..T3, T_n = the byte table followed
// by n zero bytes.
__device__ __forceinline__ uint32_t crc_word(const uint32_t* tab, uint32_t crc, uint32_t w) {
  crc ^= w;
  return tab[768 + (crc & 0xFFu)] ^ tab[512 + ((crc >> 8) & 0xFFu)] ^
         tab[256 + ((crc >> 16) & 0xFFu)] ^ tab[crc >> 24];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kP: output rows held in registers (p_bucket). kK: the number of inputs
// held in registers across the 8 bit steps when it is exactly k (6); 0
// reads the k inputs from shared memory at every bit step, for any k.
template <int kP, int kK>
__global__ void __launch_bounds__(max_threads(kP, kK), min_blocks(kP, kK))
fused_encode_crc_kernel(const uint8_t* __restrict__ data,
                        const uint8_t* __restrict__ matrix,
                        uint8_t* __restrict__ out,
                        int32_t* __restrict__ crcs,
                        const uint32_t* __restrict__ consts,
                        int k, int p, int cell, int slice, int crc_in,
                        int crc_out, uint32_t zeros_crc, int vec) {
  constexpr int kS = (kP + 3) / 4 * 4;  // mask stride, words
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = (crc_in ? k : 0) + (crc_out ? p : 0);
  const Layout L = make_layout(k, p, slice, rows);
  // Static arrays, so table loads take their base as an immediate.
  __shared__ __align__(16) uint32_t tab[kTabWords];
  __shared__ __align__(16) uint32_t byte_tab[256];
  __shared__ __align__(16) uint32_t gap[1024];
  uint32_t* ops = reinterpret_cast<uint32_t*>(smem);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.mask_off);
  uint32_t* lstate = reinterpret_cast<uint32_t*>(smem + L.state_off);
  uint8_t* sdata = smem + L.data_off;
  uint8_t* sout = smem + L.out_off;

  const int tid = threadIdx.x;
  const int nslices = cell / slice;
  const int s = blockIdx.x % nslices;
  const long long b = blockIdx.x / nslices;
  const int tile = L.tile, piece = L.piece, pitch = L.pitch, rb = L.row_bytes;
  // A thread owns at most one 16-byte position c of every row tile, at
  // offset `so` of the row in the lane-piece layout.
  const bool active = tid < tile / 16;
  const int c = tid * 16, so = (c / piece) * pitch + c % piece;

  if (rows > 0) {
    for (int i = tid; i < 256; i += blockDim.x) byte_tab[i] = consts[i];
    for (int i = tid; i < kOps * 32; i += blockDim.x) ops[i] = consts[256 + i];
  }
  if (p > 0) {
    for (int e = tid; e < k * 8 * kS; e += blockDim.x) {
      const int i = e % kS, jb = e / kS, bit = jb & 7, j = jb >> 3;
      masks[e] = (i < p && ((matrix[i * k + j] >> bit) & 1)) ? 0xFFFFFFFFu : 0u;
    }
  }
  __syncthreads();
  if (rows > 0) {  // T1..T3 from T0; the gap operator's byte tables
    for (int i = tid; i < 256; i += blockDim.x) {
      uint32_t v = byte_tab[i];
      tab[i] = v;
#pragma unroll
      for (int n = 1; n < 4; ++n) {
        v = (v >> 8) ^ byte_tab[v & 0xFFu];
        tab[n * 256 + i] = v;
      }
    }
    if (L.ntiles > 1) {
      for (int e = tid; e < 1024; e += blockDim.x) {
        const int n = e >> 8;
        uint32_t y = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if ((e >> i) & 1) y ^= ops[8 * n + i];
        gap[e] = y;
      }
    }
  }

  const uint8_t* din = data + (size_t)b * k * cell + (size_t)s * slice;
  uint8_t* dout = out + (size_t)b * p * cell + (size_t)s * slice;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int t = 0; t < L.ntiles; ++t) {
    const int v0 = t * tile - L.pad;  // slice offset of the tile's first byte
    // 1. stage the k input rows; bytes before the slice start are zeros
    if (vec) {
      if (active) {
        const int off = v0 + c;
        for (int j = 0; j < k; ++j) {
          uint8_t* dst = sdata + j * rb + so;
          if (off >= 0)
            cp_async16(dst, din + (size_t)j * cell + off);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_wait_all();
    } else {
      for (int e = tid; e < k * tile; e += blockDim.x) {
        const int j = e / tile, ce = e - j * tile, off = v0 + ce;
        sdata[j * rb + (ce / piece) * pitch + ce % piece] =
            off >= 0 ? din[(size_t)j * cell + off] : 0;
      }
    }
    __syncthreads();

    // 2. GF(2^8) apply: 16 positions a thread, Horner over coefficient bits
    if (p > 0 && active) {
      uint4 acc[kP];
#pragma unroll
      for (int i = 0; i < kP; ++i) acc[i] = make_uint4(0, 0, 0, 0);
      if constexpr (kK > 0) {
        uint4 xs[kK];
#pragma unroll
        for (int j = 0; j < kK; ++j) xs[j] = *reinterpret_cast<const uint4*>(sdata + j * rb + so);
#pragma unroll
        for (int bit = 7; bit >= 0; --bit) {
          if (bit < 7) {
#pragma unroll
            for (int i = 0; i < kP; ++i) acc[i] = xtime4(acc[i]);
          }
#pragma unroll
          for (int j = 0; j < kK; ++j) mac_row<kP, kS>(acc, xs[j], masks + (j * 8 + bit) * kS);
        }
      } else {
#pragma unroll
        for (int bit = 7; bit >= 0; --bit) {
          if (bit < 7) {
#pragma unroll
            for (int i = 0; i < kP; ++i) acc[i] = xtime4(acc[i]);
          }
          for (int j = 0; j < k; ++j) {
            const uint4 x = *reinterpret_cast<const uint4*>(sdata + j * rb + so);
            mac_row<kP, kS>(acc, x, masks + (j * 8 + bit) * kS);
          }
        }
      }
      const int off = v0 + c;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        if (i >= p) break;
        if (crc_out) *reinterpret_cast<uint4*>(sout + i * rb + so) = acc[i];
        uint8_t* o = dout + (size_t)i * cell + off;
        if (vec) {
          if (off >= 0) *reinterpret_cast<uint4*>(o) = acc[i];
        } else {
          const uint32_t wv[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (off + e >= 0) o[e] = static_cast<uint8_t>(wv[e >> 2] >> (8 * (e & 3)));
        }
      }
    }
    if (p > 0 && crc_out) __syncthreads();

    // 3. CRC: a warp takes one row; lane l continues through its piece
    for (int r = warp; r < rows; r += nwarps) {
      const uint8_t* row = (crc_in && r < k) ? sdata + r * rb : sout + (r - (crc_in ? k : 0)) * rb;
      uint32_t st = t == 0 ? 0u : advance_tab(gap, lstate[r * kLanes + lane]);
      const uint4* pc = reinterpret_cast<const uint4*>(row + lane * pitch);
      for (int i = 0; i < piece / 16; ++i) {
        const uint4 v = pc[i];
        st = crc_word(tab, st, v.x);
        st = crc_word(tab, st, v.y);
        st = crc_word(tab, st, v.z);
        st = crc_word(tab, st, v.w);
      }
      if (t + 1 < L.ntiles) {
        lstate[r * kLanes + lane] = st;
      } else {
#pragma unroll
        for (int l = 0; l < kLevels; ++l) {
          const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, st, 1 << l);
          if ((lane & ((2 << l) - 1)) == 0) st = advance(ops + (l + 1) * 32, st) ^ right;
        }
        if (lane == 0) crcs[((size_t)b * rows + r) * nslices + s] = static_cast<int32_t>(st ^ zeros_crc);
      }
    }
    __syncthreads();
  }
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int32_t*, const uint32_t*,
                        int, int, int, int, int, int, uint32_t, int);

// k = 6 (RS(6,3) and its decodes) keeps its inputs in registers; any
// other k rereads them.
template <int kP>
Kernel pick_k(int k, int p) {
  return p > 0 && k == 6 ? fused_encode_crc_kernel<kP, 6> : fused_encode_crc_kernel<kP, 0>;
}

// The kernel instance for k inputs and p outputs, with its dynamic shared
// memory limit raised to what L needs.
cudaError_t pick(const Layout& L, int k, int p, Kernel* kernel) {
  switch (p_bucket(p)) {
    case 0:
    case 1: *kernel = pick_k<1>(k, p); break;
    case 2: *kernel = pick_k<2>(k, p); break;
    case 3: *kernel = pick_k<3>(k, p); break;
    case 4: *kernel = pick_k<4>(k, p); break;
    case 8: *kernel = fused_encode_crc_kernel<8, 0>; break;
    default: *kernel = fused_encode_crc_kernel<16, 0>; break;
  }
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(L.bytes));
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
  if (p < 0 || p > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (crc_in ? k : 0) + (crc_out ? p : 0);
  const Layout L = make_layout(k, p, slice, rows);
  const int vec = cell % 16 == 0 && slice % 16 == 0 && L.pad % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = static_cast<long long>(batch) * (cell / slice);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  Kernel kernel;
  const cudaError_t err = pick(L, k, p, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), block_threads(rows, p), L.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(matrix),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(crcs),
      static_cast<const uint32_t*>(consts), k, p, cell, slice, crc_in, crc_out, zeros_crc, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_encode_crc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory one block of the kernel needs, static and dynamic, in bytes.
long long fused_encode_crc_smem_bytes(int k, int p, int slice, int rows) {
  return static_cast<long long>(make_layout(k, p, slice, rows).bytes) + kStaticBytes;
}

// Blocks of the kernel that fit on one SM for this shape (registers and
// shared memory), or minus a cudaError_t.
int fused_encode_crc_blocks_per_sm(int k, int p, int slice, int rows) {
  const Layout L = make_layout(k, p, slice, rows);
  Kernel kernel;
  cudaError_t err = pick(L, k, p, &kernel);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, block_threads(rows, p), L.bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
