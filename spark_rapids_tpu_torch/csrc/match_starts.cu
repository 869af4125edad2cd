// match_starts: where a literal byte pattern occurs in each row of a padded
// string plane.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_strings.py::match_starts
// (the `kernel` body under pl.pallas_call). Same contract:
//   out[i, j] = 1  iff  pat occurs at byte j of row i and
//                       j + L <= min(lengths[i], W)
// over data u8[n, W] (row-major, zero-padded), lengths i32[n], pat u8[L].
// The wrapper (ops/strings_kernels.py) handles L == 0 and L > W without a
// launch, as the TPU kernel does.
//
// What bounds it on an H100: bytes. At the port's main-path shape (the
// o_comment plane of TPC-H orders at SF 1: n = 2,097,152, W = 128, L = 7)
// the function must read 96.6 MB of live plane bytes and 8.4 MB of lengths
// and write the 268.4 MB mask: 373 MB, 0.111 ms at 3.35 TB/s, of which the
// mask write is 72%. The byte compares it needs take about 1% of that time
// at the card's scalar rate. The first version of this kernel (one thread
// per output byte, a 64-bit division per thread to find its row, 1-byte
// loads and stores) took 1.0944 ms there on an H100 80GB HBM3 at 700 W,
// 10% of the bound: it was bound by instruction issue, not by memory.
//
// Design: each thread owns V = 16 consecutive output positions of one row
// in each of kTiles = 2 row tiles; a block of up to 256 threads owns the two
// tiles of rows x column chunks, with blockDim = (chunks per tile row, rows
// per tile), so a thread finds its rows and column from the grid in 32-bit
// arithmetic with no division. Rows wider than 256 chunks (4096 bytes) split
// over blockIdx.y. A thread issues the loads of both tiles before it uses
// either, which doubles the bytes in flight at the same occupancy. Per row:
//   1. Read the row's length once. A row with min(len, W) < L reads no plane
//      byte and writes 16 zeros.
//   2. Read the thread's own 16-byte chunk (one uint4 load) if it holds a
//      live byte, and park it in a shared-memory row tile. Nothing past the
//      chunk that holds the row's last live byte is read.
//   3. Screen the 16 start positions four bytes at a time: __byte_perm
//      shifts the 20-byte window (own chunk + the next chunk's first word,
//      from the tile) by t = 0..3, XORs it with pat[t] broadcast and ORs the
//      results over the first min(L, 4) pattern bytes; an exact zero-byte
//      test then marks the candidates, and the fit mask drops the starts
//      past min(len, W) - L. (A SIMD compare per byte, __vcmpeq4, is
//      emulated in several instructions on this card; the XOR-OR form costs
//      two a word and byte, and the zero test three a word.)
//   4. Verify each remaining candidate from pattern byte 4 on, against the
//      row tile and the pattern in shared memory, stopping at the first
//      mismatch (bytes past the tile's columns come from global memory).
//   5. Write the 16 bools as one 16-byte store: a warp writes 512 contiguous
//      bytes.
// The vector path (kVec) needs W % 16 == 0 and 16-byte-aligned data and
// out. Every other shape (W = 8, W = 130, a view at an odd storage offset)
// takes the byte path: the same tiling with byte loads and byte stores.
// At the main-path shape this design takes about 0.147 ms on an H100 80GB
// HBM3 at 700 W (chip_smoke.py), about 76% of the bound; the bare write of
// the mask alone takes 0.084 ms there.
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kV = 16;            // output positions per thread
constexpr int kThreads = 256;     // threads per block
constexpr int kTiles = 2;         // row tiles per block
constexpr int kStaticSmem = kTiles * kThreads * kV;

// Bytes [j, j + 4) of a row as a little-endian word; bytes at or past
// `len` read as 0 and are not loaded.
__device__ __forceinline__ uint32_t load_word_bytes(const uint8_t* __restrict__ row,
                                                    int j, int len) {
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (j + q < len) w |= (uint32_t)__ldg(row + j + q) << (8 * q);
  return w;
}

// The thread's 16 bytes of a row from column j0: one 16-byte load on the
// vector path, byte loads below `len` on the byte path.
template <bool kVec>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ row, int j0, int len) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row + j0));
  return make_uint4(load_word_bytes(row, j0, len), load_word_bytes(row, j0 + 4, len),
                    load_word_bytes(row, j0 + 8, len), load_word_bytes(row, j0 + 12, len));
}

// The match mask of the thread's 16 start positions j0 .. j0 + 15 of one
// row, given its own chunk v, its row of the shared tile (trow: CT chunks
// from column col0) and the fit count nfit > 0. Bit 8q + k stands for
// position 4k + q: the layout the screen produces and the 16-byte store
// consumes cheaply.
__device__ __forceinline__ uint32_t run_mask(uint4 v, const uint4* trow, int c, int CT,
                                             const uint8_t* __restrict__ row, int col0,
                                             int j0, int len, int nfit, int L,
                                             const uint8_t* pat_s) {
  uint32_t w[5] = {v.x, v.y, v.z, v.w, 0u};
  if (c + 1 < CT) {
    w[4] = trow[c + 1].x;
  } else if (j0 + kV < len) {
    w[4] = load_word_bytes(row, j0 + kV, len);
  }
  // diff[k] byte q is zero iff pattern bytes 0 .. min(L, 4) - 1 all match
  // at position 4k + q: the window shifted by t bytes, XOR pat[t]
  // broadcast, ORed over t
  const uint32_t head = *reinterpret_cast<const uint32_t*>(pat_s);
  uint32_t diff[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < L) {
      const uint32_t b = __byte_perm(head, 0u, 0x1111u * t);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        diff[k] |= __byte_perm(w[k], w[k + 1], 0x3210u + 0x1111u * t) ^ b;
    }
  }
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // 0x80 in each zero byte of diff[k], exactly (no borrow across bytes)
    const uint32_t d = diff[k];
    const uint32_t z = ~(((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d | 0x7F7F7F7Fu);
    m |= z >> (7 - k);
    // positions 4k .. 4k + 3 that fit: bytes 0 .. nfit - 4k - 1
    const int nk = min(nfit - 4 * k, 4);
    m &= ~(0x01010101u << k) | (__funnelshift_rc(0x01010101u, 0u, 8 * (4 - nk)) << k);
  }
  if (L > 4) {
    const uint8_t* tbytes = reinterpret_cast<const uint8_t*>(trow);
    const int tile_bytes = CT * kV;
    uint32_t todo = m;
    while (todo) {
      const int bit = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int x0 = c * kV + 4 * (bit & 7) + (bit >> 3);  // column within the tile
      for (int t = 4; t < L; ++t) {
        const int x = x0 + t;
        const uint8_t b = x < tile_bytes ? tbytes[x] : __ldg(row + col0 + x);
        if (b != pat_s[t]) {
          m &= ~(1u << bit);
          break;
        }
      }
    }
  }
  return m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
match_starts_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ pat, int L, int n, int W,
                    bool* __restrict__ out) {
  __shared__ uint4 tile[kTiles][kThreads];
  extern __shared__ uint8_t pat_s[];

  const int CT = blockDim.x;  // chunks per tile row
  const int R = blockDim.y;   // rows per tile
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int slot = r * CT + c;
  for (int t = slot; t < L; t += CT * R) pat_s[t] = __ldg(pat + t);

  const int i0 = blockIdx.x * kTiles * R + r;  // the thread's row in tile 0
  const int col0 = blockIdx.y * CT * kV;       // the tiles' first column
  const int j0 = col0 + c * kV;                // the thread's first column

  // every length first, then every chunk, so that the loads of all tiles
  // are in flight together
  int len[kTiles];  // min(lengths[i], W), or 0 where the pattern cannot fit
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int i = i0 + k * R;
    len[k] = 0;
    if (i < n && j0 < W) {
      len[k] = min(max(__ldg(lengths + i), 0), W);
      if (len[k] < L) len[k] = 0;
    }
  }
  uint4 v[kTiles];
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (j0 < len[k]) v[k] = load_chunk<kVec>(data + (long long)(i0 + k * R) * W, j0, len[k]);
    tile[k][slot] = v[k];
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int i = i0 + k * R;
    if (i >= n || j0 >= W) continue;
    const long long base = (long long)i * W;
    const int nfit = min(max(len[k] - L + 1 - j0, 0), kV);  // start positions that fit
    const uint32_t m = nfit > 0 ? run_mask(v[k], &tile[k][r * CT], c, CT, data + base, col0,
                                           j0, len[k], nfit, L, pat_s)
                                : 0u;
    bool* o = out + base + j0;
    if (kVec) {
      *reinterpret_cast<uint4*>(o) = make_uint4(m & 0x01010101u, (m >> 1) & 0x01010101u,
                                                (m >> 2) & 0x01010101u, (m >> 3) & 0x01010101u);
    } else {
      const int nw = min(kV, W - j0);
      for (int q = 0; q < nw; ++q) o[q] = (m >> (8 * (q & 3) + (q >> 2))) & 1u;
    }
  }
}

template <bool kVec>
int launch(const uint8_t* data, const int32_t* lengths, const uint8_t* pat, int L,
           int n, int W, bool* out, cudaStream_t stream) {
  const int chunks = (W + kV - 1) / kV;
  const int ct = chunks < kThreads ? chunks : kThreads;
  const int rows = kThreads / ct;
  const dim3 block(ct, rows);
  const int block_rows = kTiles * rows;
  const dim3 grid((unsigned)((n + block_rows - 1) / block_rows),
                  (unsigned)((chunks + ct - 1) / ct));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ((size_t)L + 15) & ~(size_t)15;  // the pattern, read a word at a time
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_starts_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  match_starts_kernel<kVec><<<grid, block, smem, stream>>>(data, lengths, pat, L, n, W, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n*W bools), checks shapes and types, and picks the
// path: vec != 0 asks for 16-byte loads and stores, which needs W % 16 == 0
// and 16-byte-aligned data and out (else cudaErrorMisalignedAddress).
extern "C" int srt_match_starts(const uint8_t* data, const int32_t* lengths,
                                const uint8_t* pat, int L, long long n, int W,
                                int vec, bool* out, void* stream) {
  if (n <= 0 || W <= 0) return 0;
  if (L <= 0 || L > W || n > (long long)INT_MAX - kTiles * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (W % kV != 0 || reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return launch<true>(data, lengths, pat, L, (int)n, W, out, s);
  }
  return launch<false>(data, lengths, pat, L, (int)n, W, out, s);
}
