// paged_cdf_count: out[i] = |{ l < P : q[page[i] * P + l] <= r[i] }|, unsigned
//
// Replaces the Pallas TPU kernel `_paged_count_kernel` / `_paged_count_pallas`
// (pallas_call at euler_tpu/ops/pallas_kernels.py:436): the in-page step of
// the two-level inversion of a node's uint32-quantized neighbour CDF in the
// paged device sampling lane (dataflow/device.py `_draw_neighbors_paged`).
// The page-boundary binary search picks the page; this kernel counts the
// page's slots whose CDF value is <= the draw's 32 random bits. Padding
// slots hold 0xFFFFFFFF, so they count only at r == 0xFFFFFFFF (the caller
// clamps by degree).
//
// What bounds it on an H100: bytes. A draw reads one page of P u32 words
// (64 bytes at P = 16, two 32-byte sectors), its page index and its random
// word, and writes one int32: ~76 bytes for P small integer compares. The
// design keeps each draw's page read wide and independent:
//   - one thread per draw, a grid-stride loop over the draws;
//   - when P % 4 == 0 and the plane is 16-byte aligned, the page is read
//     as P / 4 `uint4` loads (a page starts at page * P * 4 bytes, a
//     multiple of 16 because 4 | P); otherwise P scalar loads;
//   - unsigned compares (`q <= r` on uint32), summed in an int;
//   - a page that is not wholly inside the plane takes the scalar path with
//     each slot index clamped into [0, n), as XLA clamps the reference's
//     gather.
// The TPU kernel DMAs the 128-lane row holding the page and masks the
// page's lanes with an iota; on Hopper the thread loads just its page.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void __launch_bounds__(kThreads)
paged_cdf_count_kernel(const uint32_t* __restrict__ q, int64_t n_elems,
                       const int32_t* __restrict__ page, const uint32_t* __restrict__ rbits,
                       int32_t* __restrict__ out, int64_t n, int p, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t base = static_cast<int64_t>(__ldg(page + i)) * p;
    const uint32_t r = __ldg(rbits + i);
    int count = 0;
    if (vec && base >= 0 && base + p <= n_elems) {
      const uint4* v = reinterpret_cast<const uint4*>(q + base);
      for (int l = 0; l < p / 4; ++l) {
        const uint4 w = __ldg(v + l);
        count += (w.x <= r) + (w.y <= r) + (w.z <= r) + (w.w <= r);
      }
    } else {
      for (int l = 0; l < p; ++l) {
        int64_t s = base + l;
        s = s < 0 ? 0 : (s >= n_elems ? n_elems - 1 : s);
        count += __ldg(q + s) <= r;
      }
    }
    out[i] = count;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// q: n_elems contiguous u32 words (int32 bit patterns); page: int32 [n];
// rbits: [n] u32 words (int32 bit patterns); out: int32 [n]; p divides 128;
// vec = 1 when p % 4 == 0 and q is 16-byte aligned.
int euler_paged_cdf_count_launch(const void* q, long long n_elems, const void* page,
                                 const void* rbits, void* out, long long n, int p, int vec,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_elems <= 0 || p <= 0 || 128 % p != 0 || (vec && p % 4 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned int grid =
      static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  paged_cdf_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), n_elems, static_cast<const int32_t*>(page),
      static_cast<const uint32_t*>(rbits), static_cast<int32_t*>(out), n, p, vec);
  return cudaGetLastError();
}

const char* euler_paged_cdf_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
