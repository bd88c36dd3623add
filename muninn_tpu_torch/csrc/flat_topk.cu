// Smallest-k over a corpus in exact f32: distance tile and running top-k
// fused in one kernel, so the [B, N] distance matrix never reaches device
// memory. This is `flat_topk`'s `precision="highest"` mode; the bf16 and
// int8 modes run on the tensor cores (csrc/flat_topk_mma.cu).
//
// Replaces: muninn_tpu/ops/pallas_flat.py `_flat_topk_kernel`, its float
// branch (pallas_flat.py:49-179) at precision="highest", launched by
// `flat_topk` (:344).
//
// Operands: the f32 rows as they are, multiplied and summed with fmaf on
// CUDA cores: exact f32 ranking. No TF32, no tensor cores, no split-precision
// emulation.
//
// Distances (smaller = better), with the same penalty row as the TPU kernel
// (pallas_flat.py:96-106, :289-296): cp[n] holds the l2 corpus sqnorm (0 for
// cosine and inner product) and +inf on masked rows, so masking and the
// metric term are one add.
//   mode 0, l2:            (qn - 2*dot) + cp
//   mode 1, cosine:        (1 - dot*cs) + cp   queries unit-normalised by the
//                          caller, cs[n] = 1/|c_n| folded in here instead of
//                          copying a normalised corpus
//   mode 2, inner product: cp - dot
//
// What bounds it on an H100: at large B the f32 FMAs on CUDA cores (67
// TFLOP/s peak, data sheet, 700 W); at small B the corpus read from HBM
// (1M x 768 f32 is 3.1 GB, about 0.92 ms at 3.35 TB/s). What the design
// does about it:
//   - An SGEMM-class main loop. A block of 256 threads holds a tile of TQ
//     queries (128 for k up to 16 and a batch above 64; fewer as k grows,
//     so the per-query buffers fit, or as the batch shrinks, so no FMA is
//     spent on empty query rows) and walks its share of the corpus in tiles
//     of 256 rows. At TQ = 128 each thread keeps 8 x 16 f32 accumulators:
//     query rows ly + 2i of its warp's 16, corpus rows lx + 16j of the
//     tile. Each 512-FMA k-step of 4 features reads one 16-byte shared load
//     per row of the thread's (8 + 16): 3 loads per 64 FMAs. Every corpus
//     element staged feeds 2*TQ flops and every query element 512, so the
//     staging traffic (L2 to the SMs) stays under the FMA time.
//   - Both operands stay K-major in shared memory, as they lie in global
//     memory ([B, d], [N, d]); a staged row is 32 features plus 4 words of
//     pad, so the 8 lanes of a quarter-warp, which read 8 consecutive corpus
//     rows, hit 8 distinct 4-bank groups, and read one query row
//     (broadcast). Nothing is transposed on the way in.
//   - Asynchronous loads: a ring of 2-4 stages of 32 features of the query
//     and corpus tiles, filled with cp.async (16-byte cp.async.cg where the
//     rows are 16-byte aligned, d % 4 == 0; 4-byte cp.async.ca otherwise),
//     the ragged edges zero-filled through the copy's source size. The
//     stages of tile after tile and chunk after chunk form one stream, so
//     the copies of step s + stages - 1 are in flight while step s is
//     multiplied; one block barrier per 32 features frees the oldest stage.
//   - The top-k beside the accumulators: each warp owns its query rows, so
//     no block barrier is needed for selection. At a tile's end a thread
//     turns all its accumulators into distances with no branch, and one vote
//     ends the tile when none beats its row's threshold (the k-th best at
//     the row's last merge); most tiles end there once the thresholds
//     settle. Otherwise, only for the thread columns where some value
//     passes (16 or 32 columns of each row at a time), the passing values
//     are appended to their rows' candidate regions at positions taken from
//     a ballot, after sorting (top-k + candidates) and keeping the first k
//     where a region would really overflow (csrc/topk_merge.cuh). The
//     per-query buffer is W = pow2(k + columns per check).
//   - When the query tiles alone cannot fill the card, the corpus is split
//     across blockIdx.y, as many ways as keep all blocks in one wave
//     (occupancy API); the wrapper merges the [S, B, k] partials. Query
//     tiles are the fastest grid dimension, so the blocks of one split read
//     the same corpus rows at about the same time and the re-reads hit L2.
//   - Ragged B, N and d are zero-filled in shared memory (a zero adds
//     nothing to a dot, so a ragged K tail stays exact); rows past B or past
//     the split are never reported. Nothing is padded or copied in device
//     memory.
//
// The tiling (TQ, W, stages) is chosen in Python (ops/flat_topk.py
// `f32_plan`), which checks its shared-memory count against
// `flat_topk_smem_bytes` when the library loads.
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"  // before(), warp_merge()

namespace {

constexpr int kThreads = 256;             // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;            // corpus rows per tile
constexpr int kDepth = 32;                // features per stage
constexpr int kStride = kDepth + 4;       // words per staged row
constexpr int kMaxK = 1024;               // largest k the kernel serves
constexpr int kMaxSplits = 256;           // most corpus splits for one query tile
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may use

// The wrapper's plan (flat_topk.py `f32_plan`): queries per block, buffer
// width, ring depth.
struct Plan {
  int tq, w, stages;
};

// A warp owns TQ / 8 query rows; its lanes form kLy lane rows of kLx lane
// columns. A thread holds kRq query rows (ly + kLy * i) by kRc corpus rows
// of the tile (lx + kLx * j).
template <int TQ>
struct Geometry {
  static constexpr int kRowsPerWarp = TQ / kWarps;
  static constexpr int kLy = kRowsPerWarp >= 2 ? 2 : 1;
  static constexpr int kLx = 32 / kLy;
  static constexpr int kRq = kRowsPerWarp / kLy;
  static constexpr int kRc = kTileRows / kLx;
  static_assert(kRq * kLy == kRowsPerWarp && kRc * kLx == kTileRows, "tiling");
};

// Columns a row can gain in one check: the lane columns.
__host__ __device__ constexpr int check_cols(int tq) {
  return tq / kWarps >= 2 ? 16 : 32;
}

// Shared memory, in 4-byte words from the base:
//   stage s [stages]: queries [TQ][kStride], corpus [kTileRows][kStride],
//   and in a tile's last stage the tile's penalty and cosine scale
//   [2][kTileRows]
//   bd [TQ][W] f32, bi [TQ][W] int32: per query, top-k in [0, k),
//   candidates after; cnt [TQ] candidates waiting; thr [TQ] threshold
__host__ __device__ constexpr int stage_words(int tq) {
  return (tq + kTileRows) * kStride + 2 * kTileRows;
}
__host__ __device__ constexpr size_t smem_bytes(Plan p) {
  return 4ull * p.stages * stage_words(p.tq) + 8ull * p.tq * p.w + 8ull * p.tq;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory; `bytes` below the copy's size
// fills the rest with zeros (0: nothing is read).
__device__ __forceinline__ void cp16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copies of one stage: features d0..d0+31 of query rows q0..
// q0+TQ-1 and of corpus rows t0..t0+255, zero past B, past the split's
// row_hi and past D; in the tile's last stage (`last`) also the tile's
// penalty and, for cosine, 1/|c|. vec: 16-byte copies (rows and both bases
// 16-byte aligned), 8 lanes to a row, so a thread copies the same 16 bytes
// of rows tid/8 + 32v; else 4-byte copies, a warp to a row.
template <int TQ>
__device__ __forceinline__ void load_stage(uint32_t st, const float* q,
                                           const float* c, const float* cp,
                                           const float* cs, int q0, int B,
                                           int t0, int row_hi, int d0, int D,
                                           bool vec, bool last, bool cosine,
                                           int tid) {
  constexpr int kRows = TQ + kTileRows;
  if (last) {
    for (int e = tid; e < (cosine ? 2 : 1) * kTileRows; e += kThreads) {
      const int g = t0 + (e & (kTileRows - 1));
      const float* src = e < kTileRows ? cp : cs;
      cp4(st + 4 * (kRows * kStride + e), g < row_hi ? src + g : src,
          g < row_hi ? 4 : 0);
    }
  }
  if (vec) {
    const int u = tid & 7, f = d0 + 4 * u;
#pragma unroll
    for (int v = 0; v < (kRows + 31) / 32; ++v) {
      const int r = (tid >> 3) + 32 * v;
      if (r >= kRows) break;
      const bool query = r < TQ;
      const int g = query ? q0 + r : t0 + r - TQ;
      const bool in = (query ? g < B : g < row_hi) && f < D;
      const float* src = in ? (query ? q : c) + (size_t)g * D + f : q;
      cp16(st + 4 * (r * kStride + 4 * u), src, in ? 16 : 0);
    }
  } else {
    const int u = tid & 31, f = d0 + u;
    for (int r = tid >> 5; r < kRows; r += kWarps) {
      const bool query = r < TQ;
      const int g = query ? q0 + r : t0 + r - TQ;
      const bool in = (query ? g < B : g < row_hi) && f < D;
      const float* src = in ? (query ? q : c) + (size_t)g * D + f : q;
      cp4(st + 4 * (r * kStride + u), src, in ? 4 : 0);
    }
  }
}

// One stage's products: acc[i][j] += <query row, corpus row> over the
// stage's 32 features, 4 at a time, in feature order.
template <int TQ>
__device__ __forceinline__ void multiply(
    const float* st, int qrow, int lx,
    float (&acc)[Geometry<TQ>::kRq][Geometry<TQ>::kRc]) {
  using G = Geometry<TQ>;
  const float* qs = st + qrow * kStride;
  const float* cs = st + (TQ + lx) * kStride;
  // unrolled twice, not 8 times: 8 times ran 6.5-9% slower on an NVIDIA
  // H100 80GB HBM3 at 700 W, likely for the size of its body (some 68 KB of
  // SASS against the instruction cache)
#pragma unroll 2
  for (int kk = 0; kk < kDepth; kk += 4) {
    float4 a[G::kRq];
#pragma unroll
    for (int i = 0; i < G::kRq; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + i * G::kLy * kStride + kk);
#pragma unroll
    for (int j = 0; j < G::kRc; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(cs + j * G::kLx * kStride + kk);
#pragma unroll
      for (int i = 0; i < G::kRq; ++i) {
        float d = acc[i][j];
        d = fmaf(a[i].x, b.x, d);
        d = fmaf(a[i].y, b.y, d);
        d = fmaf(a[i].z, b.z, d);
        d = fmaf(a[i].w, b.w, d);
        acc[i][j] = d;
      }
    }
  }
}

// One warp's part of a tile's selection. The thread's accumulators become
// distances in place, all in one form with no branch:
//   d = fma(dot, sc, rt) + cp,  rt the row term (qn for l2, 1 for cosine,
//   0 for inner product), sc the column scale (-2, -1/|c|, -1)
// which is each distance of the header with the same roundings (2*dot and
// dot*1 are exact; the cosine product is fused as the compiler contracts
// `1 - dot*cs`). A tile where no value beats its row's threshold ends at
// one vote. Otherwise, for each column of the thread's where some lane's
// value passes (kLx columns of each row), the passing values are appended at
// ballot positions, after a merge of each row whose region would overflow.
// The column loop is not unrolled (its column is selected out of the
// accumulators), so its body, with the one merge site, is compiled once.
template <int TQ>
__device__ __forceinline__ void select_tile(
    float (&acc)[Geometry<TQ>::kRq][Geometry<TQ>::kRc],
    const float (&rt)[Geometry<TQ>::kRq], const float* st, float* bd,
    int* bi, int* cnt, float* thr,
    int k, int W, int mode, int t0, int row_hi, int qrow, int live, int ly,
    int lx, int lane) {
  using G = Geometry<TQ>;
  constexpr unsigned kAll = 0xffffffffu;
  const int cap = W - k;
  const int row0 = qrow - ly;  // the warp's first query row
  const float* cpS = st + (TQ + kTileRows) * kStride;  // the tile's penalty
  const float* csS = cpS + kTileRows;                   // and 1/|c|
  // thresholds of the thread's rows; -inf: not a live row, never passes
  float t[G::kRq];
#pragma unroll
  for (int i = 0; i < G::kRq; ++i)
    t[i] = qrow + i * G::kLy < live ? thr[qrow + i * G::kLy] : -CUDART_INF_F;
  unsigned cols = 0;  // bit j: column j of the thread passes in some row
#pragma unroll
  for (int j = 0; j < G::kRc; ++j) {
    const int col = lx + j * G::kLx;
    const bool in = t0 + col < row_hi;
    const float cpj = in ? cpS[col] : CUDART_INF_F;
    const float scj = mode == 0 ? -2.f : mode == 2 ? -1.f : in ? -csS[col] : 0.f;
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      const float d = fmaf(acc[i][j], scj, rt[i]) + cpj;
      acc[i][j] = d;
      // strict: a row tied with the threshold has a larger id than the
      // entry that set it, so it would not enter. +inf (masked) and NaN
      // never pass.
      if (d < t[i]) cols |= 1u << j;
    }
  }
  cols = __reduce_or_sync(kAll, cols);
  if (cols == 0) return;
  // the lanes of this thread's lane row, and those below it among them
  const unsigned mine = G::kLy == 2 ? (ly ? 0xffff0000u : 0x0000ffffu) : kAll;
  const unsigned below = mine & ((1u << lane) - 1u);
  // Only the columns with a pass; thresholds only fall, so no other column
  // can pass later in the tile.
  for (; cols != 0; cols &= cols - 1) {
    const int j = __ffs(cols) - 1;
    float v[G::kRq];  // column j of the thread's rows
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      v[i] = acc[i][0];
#pragma unroll
      for (int jj = 1; jj < G::kRc; ++jj) v[i] = j == jj ? acc[i][jj] : v[i];
    }
    unsigned bal[G::kRq];
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) bal[i] = __ballot_sync(kAll, v[i] < t[i]);
    // rows (bit h + kLy * i) whose region this column would overflow
    unsigned over = 0;
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      const int n = __popc(bal[i] & mine);
      const unsigned b =
          __ballot_sync(kAll, n > 0 && cnt[qrow + i * G::kLy] + n > cap);
      if (G::kLy == 2)
        over |= ((b & 0xffffu) ? 1u : 0u) << (2 * i) |
                ((b >> 16) ? 2u : 0u) << (2 * i);
      else
        over |= (b ? 1u : 0u) << i;
    }
    if (over != 0) {
      for (unsigned m = over; m != 0; m &= m - 1) {
        const int r = row0 + __ffs(m) - 1;
        const float tt = warp_merge(bd + (size_t)r * W, bi + (size_t)r * W,
                                    k, cnt[r], lane);
        if (lane == 0) {
          cnt[r] = 0;
          thr[r] = tt;
        }
        __syncwarp();
      }
      // the new thresholds, for this column and the ones after it
#pragma unroll
      for (int i = 0; i < G::kRq; ++i) {
        t[i] = qrow + i * G::kLy < live ? thr[qrow + i * G::kLy] : -CUDART_INF_F;
        bal[i] = __ballot_sync(kAll, v[i] < t[i]);
      }
    }
    const int col = t0 + lx + j * G::kLx;
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      const int r = qrow + i * G::kLy;
      const int c0 = cnt[r];
      if (v[i] < t[i]) {
        const int pos = k + c0 + __popc(bal[i] & below);
        bd[(size_t)r * W + pos] = v[i];
        bi[(size_t)r * W + pos] = col;
      }
      __syncwarp();  // every lane has read cnt[r]
      if (lx == 0) cnt[r] = c0 + __popc(bal[i] & mine);
      __syncwarp();
    }
  }
}

template <int TQ>
__global__ void __launch_bounds__(kThreads, 1)
flat_topk_kernel(const float* __restrict__ q,   // [B, D]
                 const float* __restrict__ c,   // [N, D]
                 const float* __restrict__ qn,  // [B] query sqnorms (l2)
                 const float* __restrict__ cp,  // [N] penalty row
                 const float* __restrict__ cs,  // [N] 1/|c| (cosine)
                 float* __restrict__ out_d,     // [S, B, k]
                 int* __restrict__ out_i,       // [S, B, k]
                 int B, int N, int D, int k, int mode, int rows_per_split,
                 Plan plan, int vec) {
  using G = Geometry<TQ>;
  extern __shared__ __align__(16) float smem[];
  const int W = plan.w, stages = plan.stages;
  float* bd = smem + stages * stage_words(TQ);
  int* bi = reinterpret_cast<int*>(bd + (size_t)TQ * W);
  int* cnt = bi + (size_t)TQ * W;
  float* thr = reinterpret_cast<float*>(cnt + TQ);
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ly = lane / G::kLx, lx = lane % G::kLx;
  const int qrow = warp * G::kRowsPerWarp + ly;  // the thread's first query row
  const int q0 = blockIdx.x * TQ;
  const int live = min(TQ, B - q0);  // query rows of this block
  const int split = blockIdx.y;
  const int row_lo = min(split * rows_per_split, N);
  const int row_hi = min(row_lo + rows_per_split, N);

  for (int e = tid; e < TQ * W; e += kThreads) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  for (int r = tid; r < TQ; r += kThreads) {
    cnt[r] = 0;
    thr[r] = CUDART_INF_F;
  }
  float rt[G::kRq];  // the row term: qn for l2, 1 for cosine, 0 for ip
#pragma unroll
  for (int i = 0; i < G::kRq; ++i) {
    const int r = qrow + i * G::kLy;
    rt[i] = mode == 1 ? 1.f : mode == 0 && r < live ? qn[q0 + r] : 0.f;
  }
  __syncthreads();

  // the stream of stages: step g is tile g / nk, features (g % nk) * 32
  const int nk = (D + kDepth - 1) / kDepth;
  const int steps = (row_hi - row_lo + kTileRows - 1) / kTileRows * nk;
  const uint32_t stage_b = 4u * stage_words(TQ);
  auto fetch = [&](int g) {
    if (g < steps) {
      const int tile = g / nk, kc = g - tile * nk;
      load_stage<TQ>(ring + (g % stages) * stage_b, q, c, cp, cs, q0, B,
                     row_lo + tile * kTileRows, row_hi, kc * kDepth, D, vec,
                     kc == nk - 1, mode == 1, tid);
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };
  for (int g = 0; g < stages - 1; ++g) fetch(g);

  float acc[G::kRq][G::kRc];
  int kc = 0, t0 = row_lo;
  for (int g = 0; g < steps; ++g) {
    // stage g has landed once at most stages - 2 younger groups are pending
    if (stages == 4) cp_wait<2>();
    else if (stages == 3) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();  // ... for every thread; and all reads of step g - 1 are done
    fetch(g + stages - 1);  // into the slot step g - 1 used
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < G::kRq; ++i)
#pragma unroll
        for (int j = 0; j < G::kRc; ++j) acc[i][j] = 0.f;
    }
    const float* st = smem + (g % stages) * stage_words(TQ);
    multiply<TQ>(st, qrow, lx, acc);
    if (++kc == nk) {
      select_tile<TQ>(acc, rt, st, bd, bi, cnt, thr, k, W, mode, t0, row_hi,
                 qrow, live, ly, lx, lane);
      kc = 0;
      t0 += kTileRows;
    }
  }
  cp_wait<0>();

  __syncwarp();
  for (int rr = 0; rr < G::kRowsPerWarp; ++rr) {
    const int r = warp * G::kRowsPerWarp + rr;
    if (r >= live) break;
    const int n = cnt[r];
    if (n > 0) warp_merge(bd + (size_t)r * W, bi + (size_t)r * W, k, n, lane);
    const size_t o = ((size_t)split * B + q0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      out_d[o + j] = bd[(size_t)r * W + j];
      out_i[o + j] = bi[(size_t)r * W + j];
    }
    __syncwarp();
  }
}

// One launch's operands and sizes, as the C interface receives them.
struct Args {
  const float* q;
  const float* c;
  const float* qn;
  const float* cp;
  const float* cs;
  float* out_d;
  int* out_i;
  int B, N, D, k, mode;
  Plan plan;
  int splits;
  cudaStream_t stream;
};

// Sets the instance's dynamic shared memory limit, which a launch needs
// first; with per_sm, also how many blocks of the plan fit on one SM.
template <int TQ>
cudaError_t prepare(Plan p, int* per_sm) {
  const size_t smem = smem_bytes(p);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess || per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, flat_topk_kernel<TQ>, kThreads, smem);
}

cudaError_t prepare_tile(Plan p, int* per_sm) {
  switch (p.tq) {
    case 128: return prepare<128>(p, per_sm);
    case 64: return prepare<64>(p, per_sm);
    case 32: return prepare<32>(p, per_sm);
    case 16: return prepare<16>(p, per_sm);
    default: return prepare<8>(p, per_sm);
  }
}

template <int TQ>
cudaError_t launch(const Args& a) {
  cudaError_t err = prepare<TQ>(a.plan, nullptr);
  if (err != cudaSuccess) return err;
  // rows per split: a whole number of tiles; trailing splits may be empty
  const int per = (a.N + a.splits - 1) / a.splits;
  const int rows = (per + kTileRows - 1) / kTileRows * kTileRows;
  const int vec = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.c) % 16 == 0;
  const dim3 grid((a.B + TQ - 1) / TQ, a.splits);
  flat_topk_kernel<TQ><<<grid, kThreads, smem_bytes(a.plan), a.stream>>>(
      a.q, a.c, a.qn, a.cp, a.cs, a.out_d, a.out_i, a.B, a.N, a.D, a.k,
      a.mode, rows, a.plan, vec);
  return cudaGetLastError();
}

cudaError_t launch_tile(const Args& a) {
  switch (a.plan.tq) {
    case 128: return launch<128>(a);
    case 64: return launch<64>(a);
    case 32: return launch<32>(a);
    case 16: return launch<16>(a);
    default: return launch<8>(a);
  }
}

// A plan the kernel serves for k: a query tile of 8-128, a power-of-two
// buffer width holding k plus one check's columns, 2-4 stages.
bool plan_ok(int k, Plan p) {
  if (k < 1 || k > kMaxK || p.stages < kMinStages || p.stages > kMaxStages)
    return false;
  if (p.tq != 8 && p.tq != 16 && p.tq != 32 && p.tq != 64 && p.tq != 128)
    return false;
  return p.w >= k + check_cols(p.tq) && (p.w & (p.w - 1)) == 0;
}

}  // namespace

extern "C" {

int flat_topk_max_k() { return kMaxK; }

// Bytes of dynamic shared memory a launch with this plan asks for.
long long flat_topk_smem_bytes(int tq, int w, int stages) {
  return (long long)smem_bytes(Plan{tq, w, stages});
}

// How many corpus splits to give the launcher on card `device`: as many as
// keep query tiles x splits within one wave of resident blocks, at least
// 8 tiles of corpus rows per split, at most kMaxSplits, at least 1. Returns
// -(CUDA error) if the plan is refused or the card cannot be queried.
int flat_topk_splits(int B, int N, int k, int tq, int w, int stages,
                     int device) {
  const Plan p{tq, w, stages};
  if (B < 1 || !plan_ok(k, p)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = prepare_tile(p, &per_sm);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int qtiles = (B + tq - 1) / tq;
  int s = per_sm * sms / qtiles;
  const int by_rows = N / (8 * kTileRows);
  if (s > by_rows) s = by_rows;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

const char* flat_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, D] f32 (cosine: unit rows), c [N, D] f32, qn [B] f32 (read for l2),
// cp [N] f32, cs [N] f32 (read for cosine), out_d/out_i [splits, B, k]
// f32/int32; all contiguous, on card `device`. mode: 0 l2, 1 cosine,
// 2 inner product. tq, w, stages: the wrapper's plan.
int flat_topk_launch(const void* q, const void* c, const void* qn,
                     const void* cp, const void* cs, void* out_d, void* out_i,
                     int B, int N, int D, int k, int mode, int tq, int w,
                     int stages, int splits, int device, void* stream) {
  const Plan p{tq, w, stages};
  if (B < 1 || N < 0 || D < 1 || mode < 0 || mode > 2 || splits < 1 ||
      splits > kMaxSplits || !plan_ok(k, p))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(c),
               static_cast<const float*>(qn), static_cast<const float*>(cp),
               static_cast<const float*>(cs), static_cast<float*>(out_d),
               static_cast<int*>(out_i), B, N, D, k, mode, p, splits,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_tile(a));
}

}  // extern "C"
