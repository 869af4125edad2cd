// match_starts: where a literal byte pattern occurs in each row of a padded
// string plane.
//
// Replaces the TPU kernel spark_rapids_tpu/ops/pallas_strings.py::match_starts
// (the `kernel` body under pl.pallas_call). Same contract:
//   out[i, j] = 1  iff  pat occurs at byte j of row i and j + L <= lengths[i]
// over data u8[n, W] (row-major, zero-padded), lengths i32[n], pat u8[L].
// The wrapper (ops/strings_kernels.py) handles L == 0 and L > W without a
// launch, as the TPU kernel does.
//
// Design: one thread per output byte. Consecutive threads take consecutive
// j of one row, so the byte loads and the bool stores of a warp coalesce.
// Each thread checks the fit first, then compares up to L bytes and stops at
// the first mismatch. Unlike the TPU kernel, which rolls each row and lets
// the fit mask discard wrapped positions, this kernel never reads past
// column W of its row: the fit test bounds j + L by min(lengths[i], W).
//
// What bounds it on an H100: memory. It reads n*W plane bytes and 4n length
// bytes and writes n*W bools, with one compare per byte on average, far
// below the card's integer rate. Shared-memory row tiles, 16-byte loads and
// a fused contains that writes n bools are left for a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void match_starts_kernel(const uint8_t* __restrict__ data,
                                    const int32_t* __restrict__ lengths,
                                    const uint8_t* __restrict__ pat, int L,
                                    long long n, int W,
                                    bool* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * (long long)W) return;
  const long long i = idx / W;
  const int j = (int)(idx - i * W);
  int len = __ldg(lengths + i);
  if (len > W) len = W;
  bool m = j + L <= len;
  if (m) {
    const uint8_t* row = data + i * (long long)W + j;
    for (int t = 0; t < L; ++t) {
      if (__ldg(row + t) != __ldg(pat + t)) {
        m = false;
        break;
      }
    }
  }
  out[idx] = m;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (n*W bools) and checks shapes and types.
extern "C" int srt_match_starts(const uint8_t* data, const int32_t* lengths,
                                const uint8_t* pat, int L, long long n, int W,
                                bool* out, void* stream) {
  const long long total = n * (long long)W;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  match_starts_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      data, lengths, pat, L, n, W, out);
  return (int)cudaGetLastError();
}
