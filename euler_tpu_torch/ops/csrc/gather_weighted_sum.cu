// gather_weighted_sum and its dx, on Hopper.
//
//   forward: out[i, :] = sum_j w[i, j] * x[slots[i, j], :]
//   dx:      dx[slots[i, j], :] += w[i, j] * g[i, :]
//
// The forward replaces the Pallas TPU kernel `_kernel` / `_pallas_forward`
// in euler_tpu/ops/pallas_kernels.py (pallas_call at line 96). It is the
// SAGE-mean aggregation of the grid path (w = mask / degree): each dst row
// gathers D neighbour rows of the feature table and reduces them, without
// writing the [N, D, F] message tensor to device memory. The dx kernel
// replaces the custom VJP's dx (pallas_kernels.py:166-187, plain JAX
// outside any Pallas kernel): the same scatter-add of w * g, without the
// [N, D, F] product in device memory.
//
// What bounds both on an H100: bytes. Each output element costs D loads
// and D fused multiply-adds, about 0.5 flop per byte in f32, far below the
// card's ~20 flop/byte f32 ridge. On the main paths the tables are small
// (1-8 MB a launch), so what decides the time is latency: how many of a
// row's loads are in flight at once, and whether the grid fills the card.
// The design:
//   - lane groups sized to F: a dst row gets L = pow2ceil(F / VEC) lanes
//     (at most 32), a warp holds 32 / L rows. VEC is 4 f32 (16-byte
//     loads), 8 or 4 bf16 (16 or 8 bytes) when F is a multiple of it and
//     the buffer is aligned, else 1. At F = 16 f32 a row is 4 lanes, 8 rows
//     a warp; at F >= 128 a row is a whole warp and loops over column
//     chunks past 32 * VEC. L is a template parameter, chosen on the host;
//   - all D loads in flight before the first multiply-add: each lane reads
//     its row's slots and weights straight into registers (one or two
//     sectors, read as a broadcast by the row's lanes), then issues the x
//     loads of a batch of up to kBatch slots before any of them is used,
//     in a register budget of up to 80 a thread. Bounds checks are
//     predicates; D past a batch loops batch by batch (D <= 2^20);
//   - grids sized to fill the card: 4 warps a block, halved down to 1 while
//     that leaves fewer than 132 blocks, so the 128-row launches of a
//     bucket-128 predict run 64-128 one-warp blocks instead of 16 blocks
//     of 8 warps;
//   - the sum over j = 0..D-1 is taken in order in f32; bf16 features are
//     widened exactly (a 16-bit shift) on load;
//   - row offsets are 64-bit (slot * F may pass 2^31);
//   - a slot outside [0, n_src) contributes nothing (no out-of-bounds
//     access; the plain PyTorch version raises on such a slot instead);
//   - dx: a lane group loads g[i, chunk] once, then adds w[i, j] * g to
//     dx[slots[i, j], chunk] for every j with sm_90's vector reduction
//     (float4 atomicAdd, red.global.add.v4.f32), scalar atomicAdd when F
//     is not a multiple of 4. The caller zeroes dx. The product is one f32
//     multiply landing on +0.0, so where no slot repeats (the grid path)
//     dx is bitwise the plain backward's; a repeated slot's adds come in
//     an order that changes from run to run.
// The TPU kernel's 8-row tiles, per-row DMA double buffer and 128-lane
// padding do not carry over; the order of the sum does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarpsPerBlock = 4;
// the register budget is what keeps a row's loads in flight: without a
// floor on blocks per SM, ptxas fits the forward into 32 registers (full
// occupancy) and serialises the loads; 6 blocks of 128 threads leave it
// up to 80
constexpr int kMinBlocksPerSm = 6;
// slots a batch, whose loads are all in flight at once: 12 16-byte loads
// (48 registers) fit that budget beside the slots, weights and addresses;
// 16 did not, and 8 take two round trips at D = 10
constexpr int kBatch = 12;
constexpr int64_t kTargetBlocks = 132;  // one per SM of an H100
constexpr long long kMaxD = 1 << 20;

// One lane's load of VEC elements of T: raw bits, widened to f32 at use.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static Raw zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void widen(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static Raw zero() { return 0.0f; }
  __device__ static void widen(const Raw& r, float (&v)[1]) { v[0] = r; }
};

// two bf16 per 32-bit word, the lower address in the low half; a bf16 is
// the high half of the f32 with the same value
__device__ __forceinline__ void widen_word(unsigned int u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(const Raw& r, float (&v)[8]) {
    widen_word(r.x, v);
    widen_word(r.y, v + 2);
    widen_word(r.z, v + 4);
    widen_word(r.w, v + 6);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static Raw zero() { return make_uint2(0u, 0u); }
  __device__ static void widen(const Raw& r, float (&v)[4]) {
    widen_word(r.x, v);
    widen_word(r.y, v + 2);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static Raw zero() { return 0; }
  __device__ static void widen(const Raw& r, float (&v)[1]) {
    v[0] = __uint_as_float(static_cast<unsigned int>(r) << 16);
  }
};

// the batch's slots and weights, straight from the row into registers;
// ok[t] is false past D and for a slot outside [0, n_src)
__device__ __forceinline__ void load_batch(const int32_t* srow, const float* wrow, int j0, int d,
                                           int64_t n_src, int32_t (&s)[kBatch],
                                           float (&wj)[kBatch], bool (&ok)[kBatch]) {
#pragma unroll
  for (int t = 0; t < kBatch; ++t) {
    const bool in = j0 + t < d;
    s[t] = in ? __ldg(srow + j0 + t) : -1;
    wj[t] = in ? __ldg(wrow + j0 + t) : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kBatch; ++t) ok[t] = s[t] >= 0 && static_cast<int64_t>(s[t]) < n_src;
}

template <typename T, int VEC, int L>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, kMinBlocksPerSm)
gws_kernel(const T* __restrict__ x, const int32_t* __restrict__ slots,
           const float* __restrict__ w, float* __restrict__ out,
           int64_t n_dst, int d, int64_t f, int64_t n_src) {
  using V = Vec<T, VEC>;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / L;
  if (row >= n_dst) return;
  const int sub = threadIdx.x % L;
  const int32_t* srow = slots + row * d;
  const float* wrow = w + row * d;
  float* orow = out + row * f;
  for (int64_t c = static_cast<int64_t>(sub) * VEC; c < f; c += L * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int j0 = 0; j0 < d; j0 += kBatch) {
      int32_t s[kBatch];
      float wj[kBatch];
      bool ok[kBatch];
      load_batch(srow, wrow, j0, d, n_src, s, wj, ok);
      typename V::Raw r[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        r[t] = ok[t] ? V::load(x + static_cast<int64_t>(s[t]) * f + c) : V::zero();
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (ok[t]) {
          float v[VEC];
          V::widen(r[t], v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wj[t], v[k], acc[k]);
        }
      }
    }
    if constexpr (VEC == 1) {
      orow[c] = acc[0];
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        reinterpret_cast<float4*>(orow + c)[q] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  }
}

template <int VEC, int L>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, kMinBlocksPerSm)
gws_dx_kernel(const float* __restrict__ g, const int32_t* __restrict__ slots,
              const float* __restrict__ w, float* __restrict__ dx,
              int64_t n_dst, int d, int64_t f, int64_t n_src) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / L;
  if (row >= n_dst) return;
  const int sub = threadIdx.x % L;
  const int32_t* srow = slots + row * d;
  const float* wrow = w + row * d;
  const float* grow = g + row * f;
  for (int64_t c = static_cast<int64_t>(sub) * VEC; c < f; c += L * VEC) {
    float gv[VEC];
    Vec<float, VEC>::widen(Vec<float, VEC>::load(grow + c), gv);
    for (int j0 = 0; j0 < d; j0 += kBatch) {
      int32_t s[kBatch];
      float wj[kBatch];
      bool ok[kBatch];
      load_batch(srow, wrow, j0, d, n_src, s, wj, ok);
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (ok[t]) {
          float* p = dx + static_cast<int64_t>(s[t]) * f + c;
          if constexpr (VEC == 4) {
            atomicAdd(reinterpret_cast<float4*>(p),
                      make_float4(__fmul_rn(wj[t], gv[0]), __fmul_rn(wj[t], gv[1]),
                                  __fmul_rn(wj[t], gv[2]), __fmul_rn(wj[t], gv[3])));
          } else {
            atomicAdd(p, __fmul_rn(wj[t], gv[0]));
          }
        }
      }
    }
  }
}

struct Geometry {
  int lanes;
  int threads;
  int64_t rows_per_block;
  int64_t blocks;
};

Geometry geometry(int64_t f, int vec, int64_t n_dst) {
  Geometry geo;
  const int64_t need = (f + vec - 1) / vec;
  geo.lanes = 1;
  while (geo.lanes < need && geo.lanes < 32) geo.lanes <<= 1;
  const int64_t rows_per_warp = 32 / geo.lanes;
  const int64_t warps = (n_dst + rows_per_warp - 1) / rows_per_warp;
  int64_t wpb = kMaxWarpsPerBlock;
  while (wpb > 1 && (warps + wpb - 1) / wpb < kTargetBlocks) wpb >>= 1;
  geo.threads = static_cast<int>(wpb * 32);
  geo.rows_per_block = rows_per_warp * wpb;
  geo.blocks = (n_dst + geo.rows_per_block - 1) / geo.rows_per_block;
  return geo;
}

bool valid(long long n_dst, long long d, long long f, int vec, int max_vec) {
  if (n_dst < 0 || d < 0 || d > kMaxD || f <= 0) return false;
  if (vec != 1 && vec != 4 && vec != 8) return false;
  if (vec > max_vec || f % vec != 0) return false;
  return geometry(f, vec, n_dst).blocks <= 0x7fffffffLL;
}

// runs `launch(std::integral_constant<int, L>{})` for the lane count L
template <typename Launch>
cudaError_t by_lanes(int lanes, Launch&& launch) {
  switch (lanes) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
cudaError_t launch_forward(const void* x, const void* slots, const void* w, void* out,
                           int64_t n_dst, int d, int64_t f, int64_t n_src, cudaStream_t stream) {
  const Geometry geo = geometry(f, VEC, n_dst);
  return by_lanes(geo.lanes, [&](auto lanes) {
    constexpr int L = decltype(lanes)::value;
    gws_kernel<T, VEC, L><<<static_cast<unsigned int>(geo.blocks), geo.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(slots),
        static_cast<const float*>(w), static_cast<float*>(out), n_dst, d, f, n_src);
    return cudaGetLastError();
  });
}

template <int VEC>
cudaError_t launch_dx(const void* g, const void* slots, const void* w, void* dx, int64_t n_dst,
                      int d, int64_t f, int64_t n_src, cudaStream_t stream) {
  const Geometry geo = geometry(f, VEC, n_dst);
  return by_lanes(geo.lanes, [&](auto lanes) {
    constexpr int L = decltype(lanes)::value;
    gws_dx_kernel<VEC, L><<<static_cast<unsigned int>(geo.blocks), geo.threads, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const int32_t*>(slots),
        static_cast<const float*>(w), static_cast<float*>(dx), n_dst, d, f, n_src);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// The launch shape for rows of f elements loaded vec at a time, n_dst dst
// rows of d slots: out[0] lanes a row (L), out[1] rows a block, out[2]
// blocks, out[3] threads a block. Returns cudaErrorInvalidValue (and
// leaves out alone) where no launch would be made.
int euler_gws_geometry(long long f, int vec, long long n_dst, long long d, long long* out) {
  if (!valid(n_dst, d, f, vec, 8)) return cudaErrorInvalidValue;
  const Geometry geo = geometry(f, vec, n_dst);
  out[0] = geo.lanes;
  out[1] = geo.rows_per_block;
  out[2] = geo.blocks;
  out[3] = geo.threads;
  return cudaSuccess;
}

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 = queued). x: [n_src, f] f32 (x_is_bf16 = 0) or bf16 (1); slots:
// int32 [n_dst, d]; w: f32 [n_dst, d]; out: f32 [n_dst, f]; all contiguous
// on one device. vec: 4 (f32) or 8 or 4 (bf16) where f is a multiple of it
// and x is aligned to vec elements, else 1.
int euler_gws_launch(const void* x, int x_is_bf16, const void* slots, const void* w, void* out,
                     long long n_dst, long long d, long long f, long long n_src, int vec,
                     void* stream) {
  if (!valid(n_dst, d, f, vec, x_is_bf16 ? 8 : 4)) return cudaErrorInvalidValue;
  if (n_dst == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  if (x_is_bf16) {
    if (vec == 8) return launch_forward<__nv_bfloat16, 8>(x, slots, w, out, n_dst, di, f, n_src, s);
    if (vec == 4) return launch_forward<__nv_bfloat16, 4>(x, slots, w, out, n_dst, di, f, n_src, s);
    return launch_forward<__nv_bfloat16, 1>(x, slots, w, out, n_dst, di, f, n_src, s);
  }
  if (vec == 4) return launch_forward<float, 4>(x, slots, w, out, n_dst, di, f, n_src, s);
  return launch_forward<float, 1>(x, slots, w, out, n_dst, di, f, n_src, s);
}

// Launches dx[slots[i, j], :] += w[i, j] * g[i, :] on `stream`. g: f32
// [n_dst, f]; slots: int32 [n_dst, d]; w: f32 [n_dst, d]; dx: f32
// [n_src, f], zeroed by the caller; all contiguous on one device. vec: 4
// where f % 4 == 0 and g and dx are 16-byte aligned, else 1.
int euler_gws_dx_launch(const void* g, const void* slots, const void* w, void* dx,
                        long long n_dst, long long d, long long f, long long n_src, int vec,
                        void* stream) {
  if (!valid(n_dst, d, f, vec, 4)) return cudaErrorInvalidValue;
  if (n_dst == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  if (vec == 4) return launch_dx<4>(g, slots, w, dx, n_dst, di, f, n_src, s);
  return launch_dx<1>(g, slots, w, dx, n_dst, di, f, n_src, s);
}

const char* euler_gws_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
