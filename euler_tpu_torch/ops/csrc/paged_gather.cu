// paged_gather:         out[i] = flat(table)[fidx[i]]             (4-byte bits)
// paged_gather_dequant: out[i] = bf16 half fidx[i] of the u32 words, as f32
//
// Replace the Pallas TPU kernels `_paged_gather_kernel` /
// `_paged_gather_pallas` (pallas_call at euler_tpu/ops/pallas_kernels.py:247)
// and `_paged_gather_dequant_kernel` / `_paged_gather_dequant_pallas`
// (pallas_call at :356). They read a drawn neighbour's row id and edge
// weight through the paged indirection of the device sampling lane
// (dataflow/device.py `_draw_neighbors_paged`): `table` is the flat page
// buffer ([M, 128] lane rows, contiguous), `fidx` the flat element index
// page * P + slot of each draw.
//
// What bounds them on an H100: bytes, and more exactly DRAM sectors. Each
// draw reads one 4-byte element of a table of ~14 MB (the neighbour and the
// f32 weight planes at 2.5 M edges; ~7 MB packed bf16), so a draw costs one
// 32-byte sector plus its index and output words: ~12 bytes of useful
// traffic per 32-byte sector. Draws of one node land on one page, so the L2
// (50 MB) catches the repeats; the design keeps every load independent and
// in flight and does nothing else:
//   - one thread per output element, a grid-stride loop over the draws;
//   - 32-bit read-only loads (`__ldg`); the gather copies bits, so the
//     int32 neighbour plane and the f32 weight plane share one kernel;
//   - an index outside [0, n) is clamped into it, as XLA clamps a gather
//     (the callers already clamp to the last slot);
//   - the dequant form reads the u32 word at fidx >> 1 and widens its low
//     (even fidx) or high (odd fidx) half to f32 by a 16-bit shift: bf16 is
//     the top half of an f32, so the widening is exact.
// The TPU kernels' per-row DMA into a VMEM double buffer and their iota
// lane select have no counterpart: the hardware gathers 4-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 resident blocks per SM

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const uint32_t* __restrict__ table, int64_t n_elems,
                    const int32_t* __restrict__ fidx, uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __ldg(table + clamp_index(__ldg(fidx + i), n_elems));
  }
}

__global__ void __launch_bounds__(kThreads)
paged_gather_dequant_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                            const int32_t* __restrict__ fidx, float* __restrict__ out,
                            int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t f = __ldg(fidx + i);
    const uint32_t word = __ldg(words + clamp_index(static_cast<int64_t>(f >> 1), n_words));
    out[i] = __uint_as_float((f & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

unsigned int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the launch's cudaError_t (0 =
// queued). table/words: n_elems/n_words contiguous 4-byte elements; fidx:
// int32 [n]; out: [n] 4-byte (paged_gather: the table's bits; dequant: f32).
int euler_paged_gather_launch(const void* table, long long n_elems, const void* fidx,
                              void* out, long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_elems <= 0) return cudaErrorInvalidValue;
  paged_gather_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), n_elems, static_cast<const int32_t*>(fidx),
      static_cast<uint32_t*>(out), n);
  return cudaGetLastError();
}

int euler_paged_gather_dequant_launch(const void* words, long long n_words, const void* fidx,
                                      void* out, long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_words <= 0) return cudaErrorInvalidValue;
  paged_gather_dequant_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(fidx),
      static_cast<float*>(out), n);
  return cudaGetLastError();
}

const char* euler_paged_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
