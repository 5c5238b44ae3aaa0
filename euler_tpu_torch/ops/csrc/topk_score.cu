// Retrieval's two kernels: the scorer and the per-tile top-K selection.
//
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
// tensor cores (wgmma/mma reassociate the sum). Two templates of each step:
//   - mul/add: `__fmul_rn` then `__fadd_rn`, never contracted by nvcc, so
//     the kernel equals its plain PyTorch version (separate `*` and `+`
//     ops) for any f32 input;
//   - FMA: `__fmaf_rn(q, x, acc)`, one instruction. It gives the same bits
//     as the mul/add chain exactly when every product q * x is exact in
//     f32. The caller asks for it only when a host-side guard shows that
//     (12-bit significands, no product below 2^-126 or above 2^127; see
//     ops/topk_score.py `products_exact`).
//
// What bounds it on an H100: at small nq, bytes — the corpus is read once
// (512 MB at 1 M x 128) and the scores written once; at nq = 64 the
// multiply-adds (2 * 64 * 1 M * 128 operations) weigh as much as the bytes
// (0.245 against 0.229 ms). The design:
//   - a block owns a tile of consecutive corpus rows and up to 64 queries,
//     so the corpus is read from device memory once whatever the bucket;
//     past 64 queries the blocks of one row tile run side by side (query
//     group fastest) and share the tile through L2;
//   - each thread keeps an R-rows x QB-queries tile of sums in registers,
//     so every value read from shared memory feeds R or QB multiply-adds;
//     in the wide shapes a warp's lanes form 8 row lanes x 4 query lanes,
//     so one 128-bit read of a row or a query serves several lanes;
//   - d is walked in chunks of kChunk through a cp.async ring of 2-3
//     stages (16-byte copies when dp % 4 == 0 and both buffers are
//     aligned, 4-byte copies else): the next chunk arrives while this one
//     is summed;
//   - rows sit in shared memory at a stride of kChunk + 4 floats: each row
//     starts 16-byte aligned, and the float4 reads of eight consecutive
//     rows (one phase of a warp's 128-bit load) hit eight distinct bank
//     groups;
//   - the stores of one query's scores are runs of consecutive rows;
//   - 64-bit offsets: nq * nrows and nrows * dp pass 2^31 at 10 M rows.
// The TPU kernel's (8, 128) lane-row tiles and its static unroll over d
// have no counterpart here; only the order of the sum carries over.
//
// paged_topk_select: per (query, tile of T rows), the tile's top
// min(k, T) rows in descending canonical order, as int64 keys:
//   key = (order bits of the f32 score) << 32 | (0xFFFFFFFF - row),
// the order bits being the score's bits with the magnitude flipped for a
// negative float (as a signed 32-bit integer they order as the float
// does), and a row outside the mask scoring -inf. Keys are unique, so the
// top keys are `lax.top_k`'s answer with ties at the k-th place, -inf rows
// and +-0.0 ordered exactly; a tile with fewer than min(k, T) rows pads
// with INT64_MIN, below every real key. It replaces `jax.lax.top_k` over
// the masked scores (euler_tpu/retrieval/topk.py:92), which the JAX
// package runs outside any Pallas kernel; a `torch.topk` over the
// [b, ntiles * min(k, T)] candidates finishes the selection.
//
// What bounds it: bytes — each score read once (4 B), the mask once
// (1 B a row), the candidates written once. Blocks of 256 threads, about
// one wave of them, each walk a run of one query's tiles:
//   - the next tile's scores stream into shared memory by cp.async
//     (skewed by one word per thread's run, free of bank conflicts) while
//     this tile is selected; each thread then holds E = T / 256 order keys
//     of consecutive rows in registers, the mask applied as they are read;
//   - a floor under the tile's k-th key drops most keys at once: in each
//     warp the ceil(k / 8)-th largest of the lanes' largest keys, the least
//     of those over the 8 warps (at least k keys are at or above it);
//   - when at most kShortList keys are left, each one's place is its rank
//     among them; else a radix select over them, 8 bits a pass, finds the
//     k-th key v and how many keys equal to v to take (the first by row),
//     and stops early when the chosen bin holds exactly the keys still
//     needed; one block scan places the keys, then each candidate's rank
//     among the candidates gives its place in the output.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// paged_topk_score

constexpr int kChunk = 32;                // d values per pipeline stage
constexpr int kStride = kChunk + 4;       // floats between rows in shared memory

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kFma>
__device__ __forceinline__ float madd(float q, float x, float acc) {
  if constexpr (kFma) {
    return __fmaf_rn(q, x, acc);
  } else {
    return __fadd_rn(acc, __fmul_rn(q, x));
  }
}

// Copies `n` rows of `w` floats (row r at src + r * ld) to dst + r * kStride.
template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t ld, int n, int w,
                                           bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    if (w == kChunk) {
      constexpr int per = kChunk / 4;
      for (int j = t; j < n * per; j += kThreads) {
        const int r = j / per, p = j % per;
        cp_async16(dst + r * kStride + 4 * p, src + r * ld + 4 * p);
      }
    } else {
      const int per = w >> 2;  // dp % 4 == 0, so w % 4 == 0
      for (int j = t; j < n * per; j += kThreads) {
        const int r = j / per, p = j - r * per;
        cp_async16(dst + r * kStride + 4 * p, src + r * ld + 4 * p);
      }
    }
  } else {
    for (int j = t; j < n * w; j += kThreads) {
      const int r = j / w, e = j - r * w;
      cp_async4(dst + r * kStride + e, src + r * ld + e);
    }
  }
}

// The shape of a block. A warp's lanes form LR row lanes x 32 / LR query
// lanes; the block's warps form WR x WQ. Thread (lr, lq) of warp (wr, wq)
// sums R rows, wr * LR * R + lr + LR * i (i < R), against QB queries,
// wq * LQ * QB + lq + LQ * b (b < QB). With LR < 32 the lanes of a warp
// share rows and queries, so one 128-bit shared-memory read serves several
// lanes.
template <int QB, int R, int LR, int WR, int WQ, int kStages>
struct ScoreShape {
  static constexpr int kLQ = 32 / LR;
  static constexpr int kRows = WR * LR * R;
  static constexpr int kQueries = WQ * kLQ * QB;
  static constexpr int kThreads = 32 * WR * WQ;
  static constexpr int kSmemBytes =
      kStages * (kRows + kQueries) * kStride * static_cast<int>(sizeof(float));
};

template <int QB, int R, int LR, int WR, int WQ, int kStages, int kMinBlocks, bool kFma>
__global__ void __launch_bounds__(32 * WR * WQ, kMinBlocks)
paged_topk_score_kernel(const float* __restrict__ x, const float* __restrict__ q,
                        float* __restrict__ out, int64_t nrows, int dp, int nq, int ngroups,
                        int vec) {
  using Shape = ScoreShape<QB, R, LR, WR, WQ, kStages>;
  constexpr int kRowsBlk = Shape::kRows;
  constexpr int kQBlk = Shape::kQueries;
  constexpr int kThreads = Shape::kThreads;
  constexpr int LQ = Shape::kLQ;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                // [kStages][kRowsBlk][kStride]
  float* qs = smem + kStages * kRowsBlk * kStride;  // [kStages][kQBlk][kStride]

  const int64_t blk = blockIdx.x;
  const int64_t tile = blk / ngroups;
  const int q0 = static_cast<int>(blk - tile * ngroups) * kQBlk;
  const int64_t row0 = tile * kRowsBlk;
  const int rows = nrows - row0 < kRowsBlk ? static_cast<int>(nrows - row0) : kRowsBlk;
  const int nqb = nq - q0 < kQBlk ? nq - q0 : kQBlk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_row = (warp % WR) * LR * R + lane % LR;  // row i: my_row + i * LR
  const int my_q = (warp / WR) * LQ * QB + lane / LR;   // query b: my_q + b * LQ
  const int nchunks = (dp + kChunk - 1) / kChunk;
  const float* xg = x + row0 * dp;
  const float* qg = q + static_cast<int64_t>(q0) * dp;

  auto load = [&](int c) {
    const int c0 = c * kChunk;
    const int w = dp - c0 < kChunk ? dp - c0 : kChunk;
    const int stage = c % kStages;
    stage_rows<kThreads>(xs + stage * kRowsBlk * kStride, xg + c0, dp, rows, w, vec);
    stage_rows<kThreads>(qs + stage * kQBlk * kStride, qg + c0, dp, nqb, w, vec);
  };

  float acc[R][QB];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int b = 0; b < QB; ++b) acc[i][b] = 0.0f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + kStages - 1 < nchunks) load(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const int stage = c % kStages;
    const int w = dp - c * kChunk < kChunk ? dp - c * kChunk : kChunk;
    // rows that lie past the corpus, and queries past nq, compute on stale
    // shared memory; their sums are never stored
    const float* xr = xs + stage * kRowsBlk * kStride + my_row * kStride;
    const float* qr = qs + stage * kQBlk * kStride + my_q * kStride;
    auto step4 = [&](int e) {
      float4 xv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xr + i * LR * kStride + e);
      }
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + b * LQ * kStride + e);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float a = acc[i][b];
          a = madd<kFma>(qv.x, xv[i].x, a);
          a = madd<kFma>(qv.y, xv[i].y, a);
          a = madd<kFma>(qv.z, xv[i].z, a);
          a = madd<kFma>(qv.w, xv[i].w, a);
          acc[i][b] = a;
        }
      }
    };
    if (w == kChunk) {
#pragma unroll 2
      for (int e = 0; e < kChunk; e += 4) step4(e);
    } else {
      int e = 0;
      for (; e + 4 <= w; e += 4) step4(e);
      for (; e < w; ++e) {
#pragma unroll
        for (int b = 0; b < QB; ++b) {
          const float qv = qr[b * LQ * kStride + e];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][b] = madd<kFma>(qv, xr[i * LR * kStride + e], acc[i][b]);
          }
        }
      }
    }
    __syncthreads();  // stage c % kStages is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = my_row + i * LR;
    if (r >= rows) continue;
    float* o = out + row0 + r;
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      const int qb = q0 + my_q + b * LQ;
      if (qb < nq) o[static_cast<int64_t>(qb) * nrows] = acc[i][b];
    }
  }
}

template <int QB, int R, int LR, int WR, int WQ, int kStages, int kMinBlocks, bool kFma>
int launch_score(const float* x, const float* q, float* out, int64_t nrows, int dp, int nq, int vec,
                 cudaStream_t stream) {
  using Shape = ScoreShape<QB, R, LR, WR, WQ, kStages>;
  constexpr int kRowsBlk = Shape::kRows;
  constexpr int kQBlk = Shape::kQueries;
  constexpr int smem = Shape::kSmemBytes;
  const int ngroups = (nq + kQBlk - 1) / kQBlk;
  const int64_t blocks = (nrows + kRowsBlk - 1) / kRowsBlk * ngroups;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = paged_topk_score_kernel<QB, R, LR, WR, WQ, kStages, kMinBlocks, kFma>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(blocks), Shape::kThreads, smem, stream>>>(
      x, q, out, nrows, dp, nq, ngroups, vec);
  return cudaGetLastError();
}

template <bool kFma>
int launch_score_for(const float* x, const float* q, float* out, int64_t nrows, int dp, int nq,
                     int vec, cudaStream_t s) {
  // QB, R, LR, WR, WQ, stages, blocks per SM
  if (nq == 1) return launch_score<1, 1, 32, 4, 1, 3, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
  if (nq <= 2) return launch_score<2, 1, 32, 4, 1, 3, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
  if (nq <= 4) return launch_score<4, 2, 32, 4, 1, 3, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
  if (nq <= 8) return launch_score<8, 2, 32, 4, 1, 3, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
  if (nq <= 16) return launch_score<16, 2, 32, 4, 1, 2, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
  if (nq <= 32) return launch_score<8, 8, 8, 4, 1, 2, 2, kFma>(x, q, out, nrows, dp, nq, vec, s);
  // 64 queries a block; more run as query groups of 64
  return launch_score<16, 8, 8, 4, 1, 2, 1, kFma>(x, q, out, nrows, dp, nq, vec, s);
}

// ---------------------------------------------------------------------------
// paged_topk_select

constexpr int kSelThreads = 256;

__device__ __forceinline__ uint32_t order_bits(float s) {
  // unsigned order of the float: canonical_topk's high half xor 0x80000000
  const uint32_t f = __float_as_uint(s);
  return (f & 0x80000000u) ? ~f : (f | 0x80000000u);
}

// Inclusive scan of v over the block's kSelThreads threads; every thread
// also gets the block's total. wsum: kSelThreads / 32 ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  constexpr int kWarps = kSelThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  const int before = warp ? wsum[warp - 1] : 0;
  *total = wsum[kWarps - 1];
  __syncthreads();  // wsum is written again by the next scan
  return v + before;
}

// Shared memory of a select block: two key buffers (a tile's scores, row
// i at i + i / E, so that thread t's run of E rows is free of bank
// conflicts) and the candidates.
template <int E>
__host__ __device__ constexpr int select_buffer_words() {
  return kSelThreads * E + kSelThreads;
}

// Up to kShortList candidates are ranked directly, each against all
// (n^2 / 256 compares a thread), instead of radix-selected. On the
// retrieval cell (1 M rows, k 32) a full tile leaves ~60 and the kernel
// runs 1.7-1.9x faster at buckets 4-64 than with the radix select alone;
// its last tile of 576 rows leaves all of them, and ranking those directly
// (a cap of 1024) made the kernel 1.4-1.5x slower at bucket 1 than this
// cap (H100 80GB HBM3, 700 W; select_short_list.py times the caps).
constexpr int kShortList = 256;
constexpr int kMaxWarpRank = 32;  // the bound below needs ceil(k / warps) <= 32

template <int E>
__global__ void __launch_bounds__(kSelThreads)
paged_topk_select_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask,
                         int64_t* __restrict__ out, int64_t nrows, int ntiles, int kt,
                         int tiles_per_block) {
  constexpr int T = kSelThreads * E;
  constexpr int kWarps = kSelThreads / 32;
  constexpr int kWords = select_buffer_words<E>();
  extern __shared__ __align__(16) unsigned char sel_smem[];
  float* buf = reinterpret_cast<float*>(sel_smem);  // [2][kWords]
  uint64_t* cand = reinterpret_cast<uint64_t*>(sel_smem + 2 * kWords * sizeof(float));
  // two of each, used by turns, so that one step's reads and the next
  // step's writes need no barrier between them
  __shared__ int hist[2][256];
  __shared__ int chosen[2][3];  // bin, keys still needed from it, keys in it
  __shared__ uint32_t floor_key[2];
  __shared__ int wsum[kWarps];

  const int nsplit = (ntiles + tiles_per_block - 1) / tiles_per_block;
  const int64_t qi = blockIdx.x / nsplit;
  const int tile_begin = static_cast<int>(blockIdx.x % nsplit) * tiles_per_block;
  const int tile_end = tile_begin + tiles_per_block < ntiles ? tile_begin + tiles_per_block : ntiles;
  const float* srow = scores + qi * nrows;
  const int t = threadIdx.x, lane = t & 31;

  auto rows_in = [&](int tile) {
    const int64_t left = nrows - static_cast<int64_t>(tile) * T;
    return left < T ? static_cast<int>(left) : T;
  };
  auto fetch = [&](int tile, float* dst) {  // coalesced 4-byte copies, skewed in shared memory
    const int64_t first = static_cast<int64_t>(tile) * T;
    const int n = rows_in(tile);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = t + j * kSelThreads;
      if (i < n) cp_async4(dst + i + i / E, srow + first + i);
    }
  };

  if (t == 0) floor_key[0] = 0xFFFFFFFFu;
  if (tile_begin < tile_end) fetch(tile_begin, buf);
  cp_async_commit();
  for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
    const int par = it & 1;
    float* cur_buf = buf + par * kWords;
    if (tile + 1 < tile_end) fetch(tile + 1, buf + (par ^ 1) * kWords);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    if (t == 0) floor_key[par ^ 1] = 0xFFFFFFFFu;  // the next tile's
    __syncthreads();

    const int64_t first = static_cast<int64_t>(tile) * T;
    const int n = rows_in(tile);
    const int ktile = kt < n ? kt : n;
    // this thread's keys: rows t * E .. t * E + mine - 1 of the tile
    const int mine = n - t * E < 0 ? 0 : (n - t * E < E ? n - t * E : E);
    uint32_t u[E];
    uint32_t top_mine = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      u[j] = 0u;
      if (j < mine) {
        const bool keep = mask == nullptr || mask[first + t * E + j];
        u[j] = order_bits(keep ? cur_buf[t * E + j + t] : -__int_as_float(0x7F800000));
        top_mine = u[j] > top_mine ? u[j] : top_mine;
      }
    }
    // A floor under the tile's ktile-th key: in each warp the r-th largest
    // of its lanes' largest keys, r = ceil(ktile / warps), and the least of
    // those over the warps. At least warps * r >= ktile keys are at or
    // above it (a lane without keys counts as key 0, which only lowers
    // it), so the keys below it can be dropped.
    const int r = (ktile + kWarps - 1) / kWarps;
    if (r <= kMaxWarpRank) {
      int rank = 0;
      for (int l = 0; l < 32; ++l) {
        const uint32_t o = __shfl_sync(0xFFFFFFFFu, top_mine, l);
        rank += o > top_mine || (o == top_mine && l < lane);
      }
      const unsigned at = __ballot_sync(0xFFFFFFFFu, rank == r - 1);
      const uint32_t warp_floor = __shfl_sync(0xFFFFFFFFu, top_mine, __ffs(at) - 1);
      if (lane == 0) atomicMin(&floor_key[par], warp_floor);
    }
    __syncthreads();
    const uint32_t lo = r <= kMaxWarpRank ? floor_key[par] : 0u;

    int live = 0;  // keys at or above the floor
#pragma unroll
    for (int j = 0; j < E; ++j) live += j < mine && u[j] >= lo;
    int total;
    int before = block_scan(live, wsum, &total) - live;
    int64_t* o = out + (qi * ntiles + tile) * static_cast<int64_t>(kt);

    if (total <= kShortList) {
      // few enough: each key's place is its rank among them (keys are unique)
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j < mine && u[j] >= lo) {
          const uint32_t row = static_cast<uint32_t>(first + t * E + j);
          cand[before++] = (static_cast<uint64_t>(u[j]) << 32) | (0xFFFFFFFFu - row);
        }
      }
      __syncthreads();
      for (int c = t; c < total; c += kSelThreads) {
        const uint64_t me = cand[c];
        int rank = 0;
        for (int j = 0; j < total; ++j) rank += cand[j] > me;
        if (rank < ktile) o[rank] = static_cast<int64_t>(me ^ 0x8000000000000000ull);
      }
    } else {
      // radix select over the live keys: the keys taken are those whose
      // bits under `pmask` are above `prefix`, and `need` of those equal to
      // it (all, once `all`)
      uint32_t prefix = 0, pmask = 0;
      int need = ktile;
      bool all = false;
      hist[0][t] = 0;
      __syncthreads();
      for (int shift = 24, cur = 0; shift >= 0 && !all; shift -= 8, cur ^= 1) {
        int* h = hist[cur];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (j < mine && u[j] >= lo && (u[j] & pmask) == prefix) {
            atomicAdd(&h[(u[j] >> shift) & 255u], 1);
          }
        }
        hist[cur ^ 1][t] = 0;  // the next pass's histogram
        __syncthreads();
        if (t < 32) {
          // lane l holds bins 255 - 8 l down to 248 - 8 l: the bins from the top
          int c[8], sum = 0;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            c[m] = h[255 - 8 * lane - m];
            sum += c[m];
          }
          int incl = sum;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
            if (lane >= off) incl += v;
          }
          int below = incl - sum;  // keys in the bins above this lane's
          if (below < need && need <= incl) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              if (below < need && need <= below + c[m]) {
                chosen[cur][0] = 255 - 8 * lane - m;
                chosen[cur][1] = need - below;
                chosen[cur][2] = c[m];
              }
              below += c[m];
            }
          }
        }
        __syncthreads();
        prefix |= static_cast<uint32_t>(chosen[cur][0]) << shift;
        pmask |= 255u << shift;
        need = chosen[cur][1];
        all = chosen[cur][2] == need;
      }

      int gt = 0, eq = 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j < mine && u[j] >= lo) {
          const uint32_t top = u[j] & pmask;
          gt += top > prefix;
          eq += top == prefix;
        }
      }
      // both counts fit 16 bits (at most T = 8192 each)
      const int packed = gt | (eq << 16);
      before = block_scan(packed, wsum, &total) - packed;
      const int gt_before = before & 0xFFFF, eq_before = before >> 16;
      const int take_eq = all ? INT_MAX : need;
      int slot = gt_before + (eq_before < take_eq ? eq_before : take_eq);
      int eq_seen = eq_before;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j < mine && u[j] >= lo) {
          const uint32_t top = u[j] & pmask;
          const bool at = top == prefix;
          if (top > prefix || (at && eq_seen < take_eq)) {
            const uint32_t row = static_cast<uint32_t>(first + t * E + j);
            cand[slot++] = (static_cast<uint64_t>(u[j]) << 32) | (0xFFFFFFFFu - row);
          }
          eq_seen += at;
        }
      }
      __syncthreads();
      for (int c = t; c < ktile; c += kSelThreads) {
        const uint64_t me = cand[c];
        int rank = 0;
        for (int j = 0; j < ktile; ++j) rank += cand[j] > me;
        o[rank] = static_cast<int64_t>(me ^ 0x8000000000000000ull);
      }
    }
    for (int c = ktile + t; c < kt; c += kSelThreads) o[c] = INT64_MIN;
    __syncthreads();  // cand and this tile's buffer are written again
  }
}

template <int E>
int launch_select(const float* scores, const uint8_t* mask, int64_t* out, int64_t nrows, int b,
                  int kt, cudaStream_t stream) {
  constexpr int T = kSelThreads * E;
  const int64_t ntiles = (nrows + T - 1) / T;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  const int smem = 2 * select_buffer_words<E>() * static_cast<int>(sizeof(float)) +
                   (kt > kShortList ? kt : kShortList) * static_cast<int>(sizeof(uint64_t));
  auto kernel = paged_topk_select_kernel<E>;
  // about one wave of blocks, each walking its share of one query's tiles
  // so that the next tile's copy overlaps this tile's selection; the wave
  // is worked out once per device and shared-memory size
  static std::mutex mu;
  static int wave_dev = -1, wave_smem = -1;
  static int64_t wave = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int64_t blocks_in_wave;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != wave_dev || smem != wave_smem) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSelThreads, smem);
      }
      if (err != cudaSuccess) return err;
      wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
      wave_dev = dev;
      wave_smem = smem;
    }
    blocks_in_wave = wave;
  }
  const int64_t per_block = (ntiles * b + blocks_in_wave - 1) / blocks_in_wave;
  const int tiles_per_block = static_cast<int>(per_block < ntiles ? per_block : ntiles);
  const int64_t blocks = (ntiles + tiles_per_block - 1) / tiles_per_block * b;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned int>(blocks), kSelThreads, smem, stream>>>(
      scores, mask, out, nrows, static_cast<int>(ntiles), kt, tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the launch's cudaError_t (0 = queued).

// x: n_elems contiguous f32 (>= nrows * dp); q: [nq, dp] contiguous f32;
// out: [nq, nrows] contiguous f32. fma != 0 picks the FMA template.
int euler_paged_topk_score_launch(const void* x, long long n_elems, const void* q, void* out,
                                  long long nrows, int dp, int nq, int fma, void* stream) {
  if (nrows <= 0 || nq <= 0) return cudaSuccess;
  if (dp <= 0 || n_elems / dp < nrows) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  const int vec = dp % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fma ? launch_score_for<true>(xf, qf, of, nrows, dp, nq, vec, s)
             : launch_score_for<false>(xf, qf, of, nrows, dp, nq, vec, s);
}

// scores: [>= b, nrows] contiguous f32 (rows past b are never read); mask:
// nrows bytes (0 = excluded) or null; out: [b, ceil(nrows / tile), kt]
// int64 with kt = min(k, tile). tile is 8192 (the retrieval path's) or
// 1024 (many tiles at small row counts).
int euler_paged_topk_select_launch(const void* scores, long long nrows, int b, const void* mask,
                                   void* out, int kt, int tile, void* stream) {
  if (nrows <= 0 || b <= 0) return cudaSuccess;
  if (kt <= 0 || kt > tile || nrows >= 0xFFFFFFFFll) return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(scores);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 1024: return launch_select<4>(sf, m, o, nrows, b, kt, s);
    case 8192: return launch_select<32>(sf, m, o, nrows, b, kt, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* euler_topk_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
