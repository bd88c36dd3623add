// Smallest-k over a corpus in exact f32: distance tile and running top-k
// fused in one kernel, so the [B, N] distance matrix never reaches device
// memory. This is `flat_topk`'s `precision="highest"` mode; the bf16 and
// int8 modes run on the tensor cores (csrc/flat_topk_mma.cu).
//
// Replaces: muninn_tpu/ops/pallas_flat.py `_flat_topk_kernel`, its float
// branch (pallas_flat.py:49-179) at precision="highest", launched by
// `flat_topk` (:344).
//
// Operands: the f32 rows as they are, multiplied and summed with fmaf:
// exact f32 ranking.
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
// What bounds it on an H100: at large B the f32 FMAs on CUDA cores (about
// 67 TFLOP/s peak; `highest` promises exact f32 ranking, so no TF32 and no
// tensor cores); at small B the corpus read from HBM (1M x 768 f32 is
// 3.1 GB, about 0.94 ms at 3.35 TB/s). What the design does about it:
//   - One block holds a tile of TQ queries and walks its share of the corpus
//     itself, in tiles of kTileRows rows staged through shared memory
//     kDepth features at a time; each thread keeps an RQ x RC register tile of
//     dot products, accumulated with fmaf. Each corpus element read from
//     global memory feeds 2*TQ flops. A thread's RQ queries and RC rows are
//     adjacent in shared memory, so each operand is one vector load (a 4x4
//     tile: 2 shared loads per 16 FMAs).
//   - When the query tiles alone cannot fill the card, the corpus is split
//     across blockIdx.y, as many ways as keep all blocks in one wave
//     (occupancy API); the wrapper merges the [B, S*k] partial results.
//   - The per-query running top-k lives in shared memory with a threshold:
//     the k-th best distance at the last merge. Only a row that beats it is
//     appended to a candidate region; when that region could overflow, one
//     warp sorts (top-k + candidates) by (distance, id) and keeps the first k.
//     This is the TPU's "replace the worst" rule (pallas_flat.py:114-128)
//     applied in batches: after the first few tiles almost no row passes the
//     threshold, so selection costs little beside the dot products.
//   - Ragged B, N and d are masked in the kernel (zero-filled in shared
//     memory); nothing is padded or copied in device memory.
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kTileRows = 64;   // corpus rows per shared-memory tile
constexpr int kDepth = 32;      // features staged per step
constexpr int kMaxK = 1024;     // largest k the kernel serves
constexpr int kMaxSplits = 64;  // most corpus splits for one query tile

// (distance, id) order: ties go to the smaller id, as in lax.top_k.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// One warp sorts the occupied prefix of a query's buffer, (top-k, then
// `n_cand` candidates), ascending by (distance, id); keeps the first k;
// clears the rest to (+inf, -1). Returns the new threshold, the k-th best
// distance. Slots past the occupied prefix already hold (+inf, -1).
__device__ float warp_merge(float* bd, int* bi, int k, int n_cand, int lane) {
  const int m = k + n_cand;
  int p = 1;
  while (p < m) p <<= 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const float dl = bd[lo], dh = bd[hi];
        const int il = bi[lo], ih = bi[hi];
        const bool up = (lo & size) == 0;
        if (up ? before(dh, ih, dl, il) : before(dl, il, dh, ih)) {
          bd[lo] = dh; bd[hi] = dl;
          bi[lo] = ih; bi[hi] = il;
        }
      }
      __syncwarp();
    }
  }
  for (int t = k + lane; t < p; t += 32) {
    bd[t] = CUDART_INF_F;
    bi[t] = -1;
  }
  __syncwarp();
  return bd[k - 1];
}

// N adjacent floats from shared memory in one load (N = 1, 2 or 4;
// the address is N-word aligned).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    static_assert(N == 1, "vector width");
    out[0] = p[0];
  }
}

// Shared memory of one block, in 4-byte words. The +4 keeps each feature
// row 16-byte aligned for vector loads.
//   qs  [kDepth][TQ + 4]         query features, transposed
//   ct  [kDepth][kTileRows + 4]  corpus features, transposed
//   bd  [TQ][W], bi [TQ][W]      per query: top-k in [0, k), candidates after
//   cnt [TQ], thr [TQ]           candidates waiting, threshold
constexpr int kQsPad = 4;
template <int TQ>
size_t smem_bytes(int w) {
  return 4ull * (kDepth * (TQ + kQsPad) + kDepth * (kTileRows + kQsPad) +
                 2ull * TQ * w + 2 * TQ);
}

template <int TQ, int RQ, int RC>
__global__ void __launch_bounds__(kThreads)
flat_topk_kernel(const float* __restrict__ q,   // [B, D]
                 const float* __restrict__ c,   // [N, D]
                 const float* __restrict__ qn,  // [B] query sqnorms (l2)
                 const float* __restrict__ cp,  // [N] penalty row
                 const float* __restrict__ cs,  // [N] 1/|c| (cosine)
                 float* __restrict__ out_d,     // [S, B, k]
                 int* __restrict__ out_i,       // [S, B, k]
                 int B, int N, int D, int k, int mode, int rows_per_split,
                 int W) {
  constexpr int TY = TQ / RQ;         // thread rows (queries)
  constexpr int TX = kThreads / TY;   // thread columns (corpus rows)
  static_assert(TY * RQ == TQ && TX * TY == kThreads, "query tiling");
  static_assert(TX * RC == kTileRows, "corpus tiling");

  constexpr int QS = TQ + kQsPad, CS = kTileRows + kQsPad;  // row strides
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ct = qs + kDepth * QS;
  float* bd = reinterpret_cast<float*>(ct + kDepth * CS);
  int* bi = reinterpret_cast<int*>(bd + TQ * W);
  int* cnt = bi + TQ * W;
  float* thr = reinterpret_cast<float*>(cnt + TQ);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int row_lo = min(split * rows_per_split, N);
  const int row_hi = min(row_lo + rows_per_split, N);
  const int cap = W - k;  // candidate slots, >= kTileRows by construction

  for (int e = tid; e < TQ * W; e += kThreads) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  for (int r = tid; r < TQ; r += kThreads) {
    cnt[r] = 0;
    thr[r] = CUDART_INF_F;
  }

  for (int t0 = row_lo; t0 < row_hi; t0 += kTileRows) {
    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0;

    for (int d0 = 0; d0 < D; d0 += kDepth) {
      __syncthreads();  // the previous step's reads of qs/ct are done
      for (int e = tid; e < TQ * kDepth; e += kThreads) {
        const int r = e / kDepth, f = e % kDepth;
        const int gq = q0 + r, gw = d0 + f;
        qs[f * QS + r] = gq < B && gw < D ? q[(size_t)gq * D + gw] : 0.f;
      }
      for (int e = tid; e < kTileRows * kDepth; e += kThreads) {
        const int r = e / kDepth, f = e % kDepth;
        const int gr = t0 + r, gw = d0 + f;
        ct[f * CS + r] = gr < row_hi && gw < D ? c[(size_t)gr * D + gw] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int f = 0; f < kDepth; ++f) {
        float a[RQ], b[RC];
        load_vec<RQ>(qs + f * QS + ty * RQ, a);   // queries ty*RQ + i
        load_vec<RC>(ct + f * CS + tx * RC, b);   // rows tx*RC + j
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // merge first where this tile's rows might not fit the candidate region
    __syncthreads();
    for (int r = warp; r < TQ; r += kThreads / 32) {
      if (cnt[r] + kTileRows > cap) {
        const float t = warp_merge(bd + r * W, bi + r * W, k, cnt[r], lane);
        if (lane == 0) {
          cnt[r] = 0;
          thr[r] = t;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int gq = q0 + r;
      if (gq >= B) continue;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int gr = t0 + tx * RC + j;
        if (gr >= row_hi) continue;
        float dist;
        if (mode == 0) {
          const float dot = acc[i][j];
          dist = (qn[gq] - 2.f * dot) + cp[gr];
        } else if (mode == 1) {
          dist = (1.f - acc[i][j] * cs[gr]) + cp[gr];
        } else {
          dist = cp[gr] - acc[i][j];
        }
        // strict: a row tied with the threshold has a larger id than the
        // entry that set it, so it would not enter. +inf (masked) and NaN
        // never pass.
        if (dist < thr[r]) {
          const int pos = atomicAdd(&cnt[r], 1);
          bd[r * W + k + pos] = dist;
          bi[r * W + k + pos] = gr;
        }
      }
    }
  }

  __syncthreads();
  for (int r = warp; r < TQ; r += kThreads / 32) {
    if (cnt[r] > 0) warp_merge(bd + r * W, bi + r * W, k, cnt[r], lane);
  }
  __syncthreads();
  for (int e = tid; e < TQ * k; e += kThreads) {
    const int r = e / k, j = e % k;
    const int gq = q0 + r;
    if (gq < B) {
      const size_t o = ((size_t)split * B + gq) * k + j;
      out_d[o] = bd[r * W + j];
      out_i[o] = bi[r * W + j];
    }
  }
}

// Per-query buffer width: a power of two holding k entries plus a whole tile.
int buffer_width(int k) {
  int w = 1;
  while (w < k + kTileRows) w <<= 1;
  return w;
}

// Queries per block, chosen so the per-query buffers take at most 128 KB.
int query_tile(int k) {
  const int w = buffer_width(k);
  if (w <= 128) return 64;
  if (w <= 256) return 32;
  if (w <= 512) return 16;
  return 8;
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
  int B, N, D, k, mode, splits;
  cudaStream_t stream;
};

// Blocks of this instance that fit on one SM at buffer width w. Also sets
// the instance's dynamic shared memory limit, which a launch needs first.
template <int TQ, int RQ, int RC>
cudaError_t blocks_per_sm(int w, int* out) {
  const size_t smem = smem_bytes<TQ>(w);
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_kernel<TQ, RQ, RC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, flat_topk_kernel<TQ, RQ, RC>, kThreads, smem);
}

template <int TQ, int RQ, int RC>
cudaError_t launch(const Args& a) {
  const int w = buffer_width(a.k);
  const size_t smem = smem_bytes<TQ>(w);
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_kernel<TQ, RQ, RC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // rows per split: a whole number of tiles; trailing splits may be empty
  const int per = (a.N + a.splits - 1) / a.splits;
  const int rows = (per + kTileRows - 1) / kTileRows * kTileRows;
  const dim3 grid((a.B + TQ - 1) / TQ, a.splits);
  flat_topk_kernel<TQ, RQ, RC><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.c, a.qn, a.cp, a.cs, a.out_d, a.out_i, a.B, a.N, a.D, a.k,
      a.mode, rows, w);
  return cudaGetLastError();
}

cudaError_t occupancy(int k, int* per_sm) {
  const int w = buffer_width(k);
  switch (query_tile(k)) {
    case 64: return blocks_per_sm<64, 4, 4>(w, per_sm);
    case 32: return blocks_per_sm<32, 2, 4>(w, per_sm);
    case 16: return blocks_per_sm<16, 1, 4>(w, per_sm);
    default: return blocks_per_sm<8, 1, 2>(w, per_sm);
  }
}

cudaError_t launch_tile(const Args& a) {
  switch (query_tile(a.k)) {
    case 64: return launch<64, 4, 4>(a);
    case 32: return launch<32, 2, 4>(a);
    case 16: return launch<16, 1, 4>(a);
    default: return launch<8, 1, 2>(a);
  }
}

}  // namespace

extern "C" {

int flat_topk_max_k() { return kMaxK; }

// How many corpus splits to give the launcher on card `device`: as many as
// keep query tiles x splits within one wave of resident blocks, at least
// 8 tiles of corpus rows per split, at most kMaxSplits, at least 1.
// Returns -(CUDA error) if the card cannot be queried.
int flat_topk_splits(int B, int N, int k, int device) {
  if (k < 1 || k > kMaxK || B < 1) return 1;
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = occupancy(k, &per_sm);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int tq = query_tile(k);
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
// 2 inner product.
int flat_topk_launch(const void* q, const void* c, const void* qn,
                     const void* cp, const void* cs, void* out_d, void* out_i,
                     int B, int N, int D, int k, int mode, int splits,
                     int device, void* stream) {
  if (B < 1 || N < 0 || D < 1 || k < 1 || k > kMaxK || mode < 0 ||
      mode > 2 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(c),
               static_cast<const float*>(qn), static_cast<const float*>(cp),
               static_cast<const float*>(cs), static_cast<float*>(out_d),
               static_cast<int*>(out_i), B, N, D, k, mode, splits,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_tile(a));
}

}  // extern "C"
