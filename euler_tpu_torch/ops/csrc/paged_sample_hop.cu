// paged_sample_hop: one hop of the paged device draw in one launch
//
//   per source row c = cur[w] (row+1 space) and each of its k draws:
//     weighted:  pg   = |{ j < npages(c) : bound[ps(c) + j] <= r }|
//                pgc  = min(pg, max(npages - 1, 0))
//                page = min(ps + pgc, page_cap)
//                idx  = pgc * P + |{ l < P : q[page * P + l] <= r }|   (uint32 compares)
//     unit:      idx  = trunc(u * float(deg(c)))                        (f32 product)
//     idx  = min(idx, max(deg - 1, 0))
//     fidx = min(ps * P + idx, slot_cap)                                 (int32, as torch)
//     nbr  = deg > 0 ? pages[fidx] : 0
//     ew   = deg > 0 ? bf16(weight[fidx]) : +0.0                          (weighted only)
//
// Replaces, on the paged draw of the device flow (dataflow/device.py
// `_draw_neighbors_paged`), the composition that `euler_tpu/dataflow/
// device.py:922-975` builds from the Pallas TPU kernels
// `_paged_count_pallas` (pallas_call at euler_tpu/ops/pallas_kernels.py:436),
// `_paged_gather_dequant_pallas` (:356) and `_paged_gather_pallas` (:247),
// and the plain-XLA page-boundary search `paged_page_search` (:478-503),
// with the index arithmetic around them. The port keeps those three
// kernels (paged_cdf_count.cu, paged_gather.cu) and their plain versions;
// `paged_sample_hop_ref` in ops/paged.py composes them and is this
// kernel's oracle, bit for bit.
//
// What bounds it on an H100: neither bytes nor operations but the chain of
// dependent memory round trips and, before this kernel, the launches. A
// train step's hop 1 (10 240 rows x 10 draws) moves ~3 MB of distinct
// sectors and outputs, a bound of ~0.9 us at 3.35 TB/s; the composition ran
// ~98 device ops a hop (chip_smoke.py `hop_kernel_timing`), each at a
// ~1.3-2 us device floor: a page search of 5 dependent probes of a dozen
// elementwise ops each, the index arithmetic, and kernels 2-4. One draw
// here is at most four dependent reads after its row id:
//   1. the row header: deg[c], page_start[c], page_start[c + 1];
//   2. the row's page bounds, only when it spans two pages or more;
//   3. the chosen page's P CDF words;
//   4. the neighbour word and the weight word.
// Design:
//   - one launch a hop; a lane group of G = clamp(pow2ceil(k), 8, 32) lanes
//     a source row (the group shares the header loads, one broadcast
//     each), lane t taking draws t, t + G, ...; 128-thread blocks, grid
//     sized to the rows (hop 1 of a train step: 1 280 blocks on 132 SMs);
//   - the group loads its row's page bounds together, G int64 words a
//     chunk (one coalesced read per G pages, chunks looped for hubs past
//     G pages), and each lane counts the bounds <= its draw's bits through
//     G shuffles: no serial probes. A row of one page skips the bounds (pgc
//     is 0 whatever they hold);
//   - the in-page count reads the page as P / 4 `uint4`s when P % 4 == 0
//     and the plane is 16-byte aligned (a page starts at page * P * 4
//     bytes), else P clamped scalar loads, as paged_cdf_count.cu;
//   - the packed bf16 plane's half is taken from word fidx >> 1 by a 16-bit
//     shift (exact: the plain version widens it to f32 and casts back); the
//     f32 plane is rounded by `__float2bfloat16_rn`, which is torch's
//     `.to(torch.bfloat16)` on the card; the unit draw is
//     `__float2int_rz(__fmul_rn(u, __int2float_rn(deg)))`, torch's f32
//     product truncated;
//   - the three outputs are written once at their final types and shapes.
//
// Why counting the bounds <= r gives the fixed-iteration search's integer.
// Staging (dataflow/device.py `_stage_paged`) gives page j of a node the
// bound max(q[(ps + j) * P + l], l < P) of the node's quantized CDF; that
// CDF is floor(cumsum(w) / total * (2^32 - 1)) over non-negative weights,
// non-decreasing, and its padding lanes are 0xFFFFFFFF. So within one node
// the bounds are non-decreasing, and the first j with bound > r is both
// what the branchless upper-bound search converges to and the count of
// bounds <= r. The search converges when it runs at least bit_length(npages)
// + 1 iterations, which `_search_iters` guarantees for every node, and its
// index clamp (mid <= total_pages - 1) never binds inside a node's range.
// A node of one page or none has pgc = 0 whatever the search returns, so
// it reads no bound. chip_smoke.py holds the kernel bitwise against the
// composition on tables staged by the flow itself; that check, not this
// argument, is what holds it.
//
// Every clamp of the composition is kept: pgc, page <= page_cap (a trailing
// degree-0 node's page_start equals total_pages), idx <= max(deg - 1, 0),
// fidx <= slot_cap, deg > 0 for padding rows (nbr 0, ew +0.0), and every
// gather index clamped into its table as XLA clamps a gather. A row id
// outside the tables is clamped into them too (torch would raise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

enum Plane : int { kUnit = 0, kF32 = 1, kPacked = 2 };

struct Hop {
  const int32_t* cur;
  const void* draw;  // uint32 bits (weighted) or f32 uniforms (unit), [rows, k]
  int64_t rows;
  int k;
  const int32_t* deg;
  const int32_t* page_start;
  int64_t n_rows;  // valid row ids: [0, n_rows); page_start holds n_rows + 1
  const long long* bound;
  int64_t n_bound;
  const uint32_t* q;
  int64_t n_q;
  const int32_t* pages;
  int64_t n_pages;
  const uint32_t* w;
  int64_t n_w;
  int p;
  int page_cap;
  int slot_cap;
  int plane;
  int vec;
  int32_t* nbr;
  uint16_t* ew;
  int32_t* idx;
};

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// |{ l < P : q[page * P + l] <= r }|, each lane index clamped into the plane
__device__ __forceinline__ int in_page_count(const Hop& h, int32_t page, uint32_t r) {
  const int64_t base = static_cast<int64_t>(page) * h.p;
  int count = 0;
  if (h.vec && base >= 0 && base + h.p <= h.n_q) {
    const uint4* v = reinterpret_cast<const uint4*>(h.q + base);
    for (int l = 0; l < h.p / 4; ++l) {
      const uint4 x = __ldg(v + l);
      count += (x.x <= r) + (x.y <= r) + (x.z <= r) + (x.w <= r);
    }
  } else {
    for (int l = 0; l < h.p; ++l) count += __ldg(h.q + clamp_index(base + l, h.n_q)) <= r;
  }
  return count;
}

template <int G>
__global__ void __launch_bounds__(kThreads) paged_sample_hop_kernel(const Hop h) {
  const int t = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool active = row < h.rows;
  // 1. the row header, one broadcast read per word for the whole group
  const int32_t c =
      active ? static_cast<int32_t>(clamp_index(__ldg(h.cur + row), h.n_rows)) : 0;
  const int32_t deg = active ? __ldg(h.deg + c) : 0;
  const int32_t ps = active ? __ldg(h.page_start + c) : 0;
  const int32_t npages = active ? __ldg(h.page_start + c + 1) - ps : 0;
  const int32_t last = deg > 1 ? deg - 1 : 0;
  // bound chunks of this group; every lane of the warp runs the warp's
  // largest count, so the shuffles see the whole warp
  const int chunks = (h.plane != kUnit && npages > 1) ? (npages + G - 1) / G : 0;
  const int warp_chunks = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(chunks)));

  for (int base = 0; base < h.k; base += G) {
    const int j = base + t;
    const bool live = active && j < h.k;
    const int64_t o = row * h.k + j;
    int32_t idx;
    if (h.plane == kUnit) {
      const float u = live ? __ldg(static_cast<const float*>(h.draw) + o) : 0.0f;
      idx = __float2int_rz(__fmul_rn(u, __int2float_rn(deg)));
    } else {
      const uint32_t r = live ? __ldg(static_cast<const uint32_t*>(h.draw) + o) : 0u;
      // 2. pages skipped: the row's bounds <= r
      int pg = 0;
      for (int ch = 0; ch < warp_chunks; ++ch) {
        const int first = ch * G;
        uint32_t b = 0;
        if (ch < chunks && first + t < npages) {
          b = static_cast<uint32_t>(
              __ldg(h.bound + clamp_index(static_cast<int64_t>(ps) + first + t, h.n_bound)));
        }
        for (int s = 0; s < G; ++s) {
          const uint32_t bs = __shfl_sync(kFull, b, s, G);
          pg += (ch < chunks && first + s < npages && bs <= r);
        }
      }
      const int32_t pgc = min(pg, max(npages - 1, 0));
      const int32_t page = min(ps + pgc, h.page_cap);
      // 3. the in-page count
      idx = pgc * h.p + (live ? in_page_count(h, page, r) : 0);
    }
    if (!live) continue;
    idx = min(idx, last);
    // ps * P + idx in wrapping int32 arithmetic, as torch computes it
    const int32_t fidx = min(static_cast<int32_t>(static_cast<uint32_t>(ps) * static_cast<uint32_t>(h.p) +
                                                  static_cast<uint32_t>(idx)),
                             h.slot_cap);
    // 4. the neighbour and weight words
    h.idx[o] = idx;
    h.nbr[o] = deg > 0 ? __ldg(h.pages + clamp_index(fidx, h.n_pages)) : 0;
    if (h.plane == kPacked) {
      uint16_t bits = 0;
      if (deg > 0) {
        const uint32_t word = __ldg(h.w + clamp_index(fidx >> 1, h.n_w));
        bits = static_cast<uint16_t>((fidx & 1) ? (word >> 16) : (word & 0xffffu));
      }
      h.ew[o] = bits;
    } else if (h.plane == kF32) {
      uint16_t bits = 0;
      if (deg > 0) {
        const float x = __uint_as_float(__ldg(h.w + clamp_index(fidx, h.n_w)));
        bits = __bfloat16_as_ushort(__float2bfloat16_rn(x));
      }
      h.ew[o] = bits;
    }
  }
}

int group_for(int k) {
  int g = 8;
  while (g < k && g < 32) g *= 2;
  return g;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// cur: int32 [rows]; draw: [rows, k] u32 bits (plane 1, 2) or f32 (plane 0);
// deg: int32 [n_rows]; page_start: int32 [n_rows + 1]; bound: int64
// [n_bound] u32 values; q: u32 [n_q]; pages: int32 [n_pages]; w: [n_w] u32
// words (plane 2: packed bf16 pairs; plane 1: f32 bits); nbr, idx: int32
// [rows * k]; ew: bf16 bits [rows * k] (planes 1, 2); p divides 128; vec = 1
// when p % 4 == 0 and q is 16-byte aligned. Plane 0 (unit weights) reads no
// bound, q or w.
int euler_paged_sample_hop_launch(const void* cur, long long rows, int k, const void* draw,
                                  const void* deg, const void* page_start, long long n_rows,
                                  const void* bound, long long n_bound, const void* q,
                                  long long n_q, const void* pages, long long n_pages,
                                  const void* w, long long n_w, int p, int page_cap,
                                  int slot_cap, int plane, int vec, void* nbr, void* ew,
                                  void* idx, void* stream) {
  if (rows <= 0 || k <= 0) return cudaSuccess;
  if (n_rows <= 0 || n_pages <= 0 || p <= 0 || 128 % p != 0 || plane < kUnit ||
      plane > kPacked || (vec && p % 4 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (plane != kUnit && (n_bound <= 0 || n_q <= 0 || n_w <= 0)) return cudaErrorInvalidValue;
  Hop h{static_cast<const int32_t*>(cur), draw, rows, k,
        static_cast<const int32_t*>(deg), static_cast<const int32_t*>(page_start), n_rows,
        static_cast<const long long*>(bound), n_bound, static_cast<const uint32_t*>(q), n_q,
        static_cast<const int32_t*>(pages), n_pages, static_cast<const uint32_t*>(w), n_w,
        p, page_cap, slot_cap, plane, vec, static_cast<int32_t*>(nbr),
        static_cast<uint16_t*>(ew), static_cast<int32_t*>(idx)};
  const int g = group_for(k);
  const long long blocks = (rows * g + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 8: paged_sample_hop_kernel<8><<<grid, kThreads, 0, s>>>(h); break;
    case 16: paged_sample_hop_kernel<16><<<grid, kThreads, 0, s>>>(h); break;
    default: paged_sample_hop_kernel<32><<<grid, kThreads, 0, s>>>(h); break;
  }
  return cudaGetLastError();
}

const char* euler_paged_sample_hop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
