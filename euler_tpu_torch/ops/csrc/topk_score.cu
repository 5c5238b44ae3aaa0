// paged_topk_score: scores[b, i] = sum over d of q[b, d] * x[i, d], the sum
// taken strictly left to right over d in f32:
//   acc = 0; for d in 0..dp-1: acc = f32(acc + f32(q[b, d] * x[i, d]))
//
// Replaces the Pallas TPU kernel `_topk_score_kernel` /
// `_paged_topk_score_pallas` (pallas_call at
// euler_tpu/ops/pallas_kernels.py:534), the brute-force scorer behind
// retrieval's `TopKIndex.search`. `x` is the flat corpus buffer (the
// [M, 128] lane-row view, contiguous) holding `nrows` packed dp-wide f32
// vectors, row i at x[i * dp]; anything after nrows * dp is padding and is
// never read. `q` is [nq, dp] f32 and `out` [nq, nrows] f32.
//
// The order of the sum is the contract: every impl and the NumPy oracle
// agree bitwise because each takes the same chain of roundings. So no
// tensor cores (wgmma/mma reassociate the sum) and no FMA: `__fmul_rn` and
// `__fadd_rn` are never contracted by nvcc, which makes the kernel bitwise
// equal to its plain PyTorch version (separate `*` and `+` ops) for any f32
// input, not only the 12-bit-significand operands retrieval feeds it.
//
// What bounds it on an H100: at small nq, bytes — the corpus is read once
// (512 MB at 1 M x 128) and the scores written once; at nq = 64 the
// multiply-adds pass the bytes, and without FMA each one is two
// instructions. The design:
//   - a block owns kRows consecutive corpus rows (one per thread) and QB
//     queries (a template width: 1, 2, 4, 8, 16 or 32); its rows are one
//     contiguous run of the flat buffer;
//   - d is walked in chunks of kChunk: the block stages its rows' chunk in
//     shared memory with coalesced 16-byte loads (4-byte loads when dp is
//     not a multiple of 4), at an odd row stride so that the column reads
//     below hit 32 distinct banks, and the queries' chunk as [d][QB];
//   - each thread walks its row's d in order, keeping QB accumulators in
//     registers; every thread reads the same query values (a broadcast);
//   - the stores of one query's scores are consecutive rows: coalesced;
//   - blocks are numbered query group fastest, so the groups of one row
//     tile run side by side and all but the first find the tile in L2: the
//     corpus comes from device memory about once whatever nq is;
//   - 64-bit offsets: nq * nrows and nrows * dp pass 2^31 at 10 M rows.
// The TPU kernel's (8, 128) lane-row tiles and its static unroll over d
// have no counterpart here; only the order of the sum carries over.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // corpus rows per block, one per thread
constexpr int kChunk = 32;   // d values staged per pass

template <int QB>
__global__ void __launch_bounds__(kRows)
paged_topk_score_kernel(const float* __restrict__ x, const float* __restrict__ q,
                        float* __restrict__ out, int64_t nrows, int dp, int nq,
                        int ngroups, int vec) {
  __shared__ float xs[kRows * (kChunk + 1)];
  __shared__ __align__(16) float qs[kChunk * QB];
  const int64_t blk = blockIdx.x;
  const int64_t tile = blk / ngroups;
  const int b0 = static_cast<int>(blk - tile * ngroups) * QB;
  const int64_t row0 = tile * kRows;
  const int rows = nrows - row0 < kRows ? static_cast<int>(nrows - row0) : kRows;
  const int t = threadIdx.x;

  float acc[QB];
#pragma unroll
  for (int b = 0; b < QB; ++b) acc[b] = 0.0f;

  for (int c0 = 0; c0 < dp; c0 += kChunk) {
    const int w = dp - c0 < kChunk ? dp - c0 : kChunk;
    const int stride = w | 1;  // odd: row t's element e sits in bank (t*stride + e) % 32
    const float* base = x + row0 * dp + c0;
    if (vec) {
      // dp % 4 == 0 and x 16-byte aligned, so every row chunk is too
      const int per_row = w >> 2;
      const int n4 = rows * per_row;
      for (int j = t; j < n4; j += kRows) {
        const int r = j / per_row;
        const int p = j - r * per_row;
        const float4 v = __ldg(reinterpret_cast<const float4*>(base + static_cast<int64_t>(r) * dp) + p);
        float* dst = xs + r * stride + 4 * p;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      const int n = rows * w;
      for (int j = t; j < n; j += kRows) {
        const int r = j / w;
        const int e = j - r * w;
        xs[r * stride + e] = __ldg(base + static_cast<int64_t>(r) * dp + e);
      }
    }
    for (int j = t; j < w * QB; j += kRows) {
      const int e = j / QB;
      const int b = j - e * QB;
      qs[j] = b0 + b < nq ? __ldg(q + static_cast<int64_t>(b0 + b) * dp + c0 + e) : 0.0f;
    }
    __syncthreads();
    if (t < rows) {
      const float* xr = xs + t * stride;
      for (int e = 0; e < w; ++e) {
        const float xv = xr[e];
        const float* qe = qs + e * QB;
#pragma unroll
        for (int b = 0; b < QB; ++b) acc[b] = __fadd_rn(acc[b], __fmul_rn(qe[b], xv));
      }
    }
    __syncthreads();
  }
  if (t < rows) {
    float* o = out + row0 + t;
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      if (b0 + b < nq) o[static_cast<int64_t>(b0 + b) * nrows] = acc[b];
    }
  }
}

template <int QB>
int launch(const float* x, const float* q, float* out, int64_t nrows, int dp, int nq, int vec,
           cudaStream_t stream) {
  const int ngroups = (nq + QB - 1) / QB;
  const int64_t blocks = (nrows + kRows - 1) / kRows * ngroups;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  paged_topk_score_kernel<QB><<<static_cast<unsigned int>(blocks), kRows, 0, stream>>>(
      x, q, out, nrows, dp, nq, ngroups, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// x: n_elems contiguous f32 (>= nrows * dp); q: [nq, dp] contiguous f32;
// out: [nq, nrows] contiguous f32.
int euler_paged_topk_score_launch(const void* x, long long n_elems, const void* q, void* out,
                                  long long nrows, int dp, int nq, void* stream) {
  if (nrows <= 0 || nq <= 0) return cudaSuccess;
  if (dp <= 0 || n_elems / dp < nrows) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  const int vec = dp % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 1) return launch<1>(xf, qf, of, nrows, dp, nq, vec, s);
  if (nq <= 2) return launch<2>(xf, qf, of, nrows, dp, nq, vec, s);
  if (nq <= 4) return launch<4>(xf, qf, of, nrows, dp, nq, vec, s);
  if (nq <= 8) return launch<8>(xf, qf, of, nrows, dp, nq, vec, s);
  if (nq <= 16) return launch<16>(xf, qf, of, nrows, dp, nq, vec, s);
  return launch<32>(xf, qf, of, nrows, dp, nq, vec, s);
}

const char* euler_topk_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
