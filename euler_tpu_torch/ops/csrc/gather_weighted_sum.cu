// gather_weighted_sum: out[i, :] = sum_j w[i, j] * x[slots[i, j], :]
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_forward` in
// euler_tpu/ops/pallas_kernels.py (pallas_call at line 96). It is the
// SAGE-mean aggregation of the grid path (w = mask / degree): each dst row
// gathers D neighbour rows of the feature table and reduces them, without
// writing the [N, D, F] message tensor to device memory.
//
// What bounds it on an H100: bytes. Each output element costs D loads and
// D fused multiply-adds, so the work is N*D*F*2 flops against
// N*D*F*sizeof(x) gathered bytes: about 0.5 flop per byte in f32, far
// below the card's ~20 flop/byte f32 ridge. The design therefore only
// tries to keep the loads wide and in flight:
//   - one warp per dst row, kWarpsPerBlock rows per block;
//   - the row's D slots and weights are staged once in shared memory, so
//     the feature-chunk loop reads them as broadcasts;
//   - lanes stride over F with 16-byte (f32) or 8-byte (bf16) loads when
//     F % 4 == 0 and the table is aligned, and with scalar loads otherwise;
//   - the sum over j = 0..D-1 is taken in order in f32; bf16 features are
//     widened exactly (a 16-bit shift) on load;
//   - row offsets are 64-bit (slot * F may pass 2^31);
//   - a slot outside [0, n_src) contributes nothing (no out-of-bounds
//     read; the plain PyTorch version raises on such a slot instead).
// The TPU kernel's per-row DMA into a VMEM double buffer has no
// counterpart here: the warp's independent loads over j play its part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kDefaultSmemBytes = 48 * 1024;

template <typename T, int VEC>
struct Row;

template <>
struct Row<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Row<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
};

template <>
struct Row<__nv_bfloat16, 4> {
  // two bf16 per 32-bit word, the lower address in the low half; a bf16
  // is the high half of the f32 with the same value
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
};

template <>
struct Row<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __uint_as_float(static_cast<unsigned int>(u) << 16);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gws_kernel(const T* __restrict__ x, const int32_t* __restrict__ slots,
           const float* __restrict__ w, float* __restrict__ out,
           int64_t n_dst, int d, int64_t f, int64_t n_src) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= n_dst) return;  // warp-uniform

  int32_t* s_slot = reinterpret_cast<int32_t*>(smem) + warp * d;
  float* s_w = reinterpret_cast<float*>(smem + sizeof(int32_t) * kWarpsPerBlock * d) + warp * d;
  for (int j = lane; j < d; j += 32) {
    s_slot[j] = slots[row * d + j];
    s_w[j] = w[row * d + j];
  }
  __syncwarp();

  float* orow = out + row * f;
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < f; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      const int64_t s = s_slot[j];
      if (s < 0 || s >= n_src) continue;
      const float wj = s_w[j];
      float v[VEC];
      Row<T, VEC>::load(x + s * f + c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wj, v[k], acc[k]);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(orow + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      orow[c] = acc[0];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* slots, const void* w, void* out,
                   int64_t n_dst, int d, int64_t f, int64_t n_src, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * d * (sizeof(int32_t) + sizeof(float));
  if (smem > kDefaultSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        gws_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gws_kernel<T, VEC><<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(slots), static_cast<const float*>(w),
      static_cast<float*>(out), n_dst, d, f, n_src);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// x: [n_src, f] f32 (x_is_bf16 = 0) or bf16 (1); slots: int32 [n_dst, d];
// w: f32 [n_dst, d]; out: f32 [n_dst, f]; all contiguous on one device.
// vec is 4 (f % 4 == 0 and x aligned to 4 elements) or 1.
int euler_gws_launch(const void* x, int x_is_bf16, const void* slots, const void* w, void* out,
                     long long n_dst, long long d, long long f, long long n_src, int vec,
                     void* stream) {
  if (n_dst <= 0) return cudaSuccess;
  if (d < 0 || f <= 0 || (vec != 1 && vec != 4) || (vec == 4 && f % 4 != 0) ||
      (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL || d > (1 << 20)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  if (x_is_bf16) {
    return vec == 4 ? launch<__nv_bfloat16, 4>(x, slots, w, out, n_dst, di, f, n_src, s)
                    : launch<__nv_bfloat16, 1>(x, slots, w, out, n_dst, di, f, n_src, s);
  }
  return vec == 4 ? launch<float, 4>(x, slots, w, out, n_dst, di, f, n_src, s)
                  : launch<float, 1>(x, slots, w, out, n_dst, di, f, n_src, s);
}

const char* euler_gws_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
