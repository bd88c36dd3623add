// Smallest-k over a corpus: distance tile and running top-k fused in one
// kernel, so the [B, N] distance matrix never reaches device memory.
//
// Replaces: muninn_tpu/ops/pallas_flat.py `_flat_topk_kernel`, both
// branches (pallas_flat.py:49-179): the float branch, launched by
// `flat_topk` (:344) at precision="highest" and "default"/"bfloat16", and
// the int8 branch (:74-88, :171-176), launched by `flat_topk_int8` (:452)
// and by `flat_topk` at precision="int8".
//
// Operand modes (template parameter kOp):
//   highest          the f32 operands as they are: exact f32 ranking.
//   default/bfloat16 the unit query and the raw corpus row are rounded to
//                    bf16 (round to nearest even) as they are staged into
//                    shared memory, then multiplied and summed in f32. On
//                    the TPU "default" is one bf16 MXU pass over f32
//                    inputs (pallas_flat.py:317-320) and "bfloat16" casts
//                    the inputs to bf16 before the same pass (:299-301), so
//                    both rank by bf16-rounded operands summed in f32. A
//                    product of two bf16 values is exact in f32, so this
//                    mode and its plain version differ only in summation
//                    order. The epilogue (qn, the penalty row, 1/|c|) stays
//                    f32 from the unrounded rows.
//   int8             int8 query and corpus rows (symmetric per-row
//                    quantization, quantize_rows_int8), multiplied four
//                    at a time with __dp4a into an int32 accumulator:
//                    exact, so kernel and plain version compute the same
//                    integer dots. Staged as 4-byte words, 4 features each.
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
//   int8 (cosine and inner product alike): the rank-only tile of the TPU
//                          kernel, cp - f32(dot) * cs with cs[n] the corpus
//                          row's dequantization scale, each step rounded
//                          (no FMA contraction) as the plain version rounds
//                          it. The query scale is constant within a row, so
//                          it does not change the ranking: the wrapper
//                          rescales the k survivors to base + qs * value
//                          after merging the splits on the rank-only values.
//
// What bounds it on an H100: at large B the f32 FMAs on CUDA cores (about
// 67 TFLOP/s peak; `highest` promises exact f32 ranking, so no TF32 and no
// tensor cores; the bf16 mode runs the same FMAs, and bf16 tensor cores are
// later work); at small B the corpus read from HBM (1M x 768 f32 is 3.1 GB,
// about 0.94 ms at 3.35 TB/s). The int8 mode runs __dp4a on CUDA cores, far
// below the int8 tensor-core peak (1,979 TOP/s); IMMA or wgmma s8 tiles are
// later work. What the design does about it:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kTileRows = 64;   // corpus rows per shared-memory tile
constexpr int kDepth = 32;      // words staged per step: 32 f32, 128 int8
constexpr int kMaxK = 1024;     // largest k the kernel serves
constexpr int kMaxSplits = 64;  // most corpus splits for one query tile

// Operand modes: f32 as stored, f32 rounded to bf16, int8.
constexpr int kF32 = 0, kBf16 = 1, kInt8 = 2;

// The staged 4-byte word and the accumulator of a mode: one f32 feature
// and an f32 sum, or four int8 features and an int32 sum.
template <int kOp>
using Word = typename std::conditional<kOp == kInt8, int, float>::type;

// An f32 operand as the kernel multiplies it: as stored, or rounded to bf16.
template <int kOp>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kOp == kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Four int8 features 4w..4w+3 of a row as one word, the lowest feature in
// the lowest byte (__dp4a's order); features at or past D are 0. `aligned`:
// the row starts 4-byte aligned and D % 4 == 0, so one load does.
__device__ __forceinline__ int int8_word(const int8_t* row, int w, int D,
                                         int aligned) {
  if (aligned) return __ldg(reinterpret_cast<const int*>(row) + w);
  int out = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int f = 4 * w + t;
    if (f < D) out |= static_cast<int>(static_cast<uint8_t>(row[f])) << (8 * t);
  }
  return out;
}

__device__ __forceinline__ float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ int mac(int a, int b, int acc) {
  return __dp4a(a, b, acc);
}

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

// N adjacent 4-byte words from shared memory in one load (N = 1, 2 or 4;
// the address is N-word aligned).
template <typename T, int N> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<int, 4> { using type = int4; };
template <> struct Vec<int, 2> { using type = int2; };

template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, T* out) {
  if constexpr (N == 4) {
    const auto v = *reinterpret_cast<const typename Vec<T, 4>::type*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const auto v = *reinterpret_cast<const typename Vec<T, 2>::type*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    static_assert(N == 1, "vector width");
    out[0] = p[0];
  }
}

// Shared memory of one block, in 4-byte words. The +4 keeps each feature
// row 16-byte aligned for vector loads.
//   qs  [kDepth][TQ + 4]         query words (one feature, or four int8), transposed
//   ct  [kDepth][kTileRows + 4]  corpus words, transposed
//   bd  [TQ][W], bi [TQ][W]      per query: top-k in [0, k), candidates after
//   cnt [TQ], thr [TQ]           candidates waiting, threshold
constexpr int kQsPad = 4;
template <int TQ>
size_t smem_bytes(int w) {
  return 4ull * (kDepth * (TQ + kQsPad) + kDepth * (kTileRows + kQsPad) +
                 2ull * TQ * w + 2 * TQ);
}

template <int TQ, int RQ, int RC, int kOp>
__global__ void __launch_bounds__(kThreads)
flat_topk_kernel(const void* __restrict__ qv,   // [B, D] f32, or int8
                 const void* __restrict__ cv,   // [N, D] f32, or int8
                 const float* __restrict__ qn,  // [B] query sqnorms (l2)
                 const float* __restrict__ cp,  // [N] penalty row
                 const float* __restrict__ cs,  // [N] 1/|c| (cosine), or the
                                                // int8 dequantization scales
                 float* __restrict__ out_d,     // [S, B, k]
                 int* __restrict__ out_i,       // [S, B, k]
                 int B, int N, int D, int k, int mode, int rows_per_split,
                 int W, int aligned) {
  using T = Word<kOp>;
  constexpr int TY = TQ / RQ;         // thread rows (queries)
  constexpr int TX = kThreads / TY;   // thread columns (corpus rows)
  static_assert(TY * RQ == TQ && TX * TY == kThreads, "query tiling");
  static_assert(TX * RC == kTileRows, "corpus tiling");

  constexpr int QS = TQ + kQsPad, CS = kTileRows + kQsPad;  // row strides
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ct = qs + kDepth * QS;
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

  // words per row: one per feature, or one per four int8 features
  const int DW = kOp == kInt8 ? (D + 3) / 4 : D;
  for (int t0 = row_lo; t0 < row_hi; t0 += kTileRows) {
    T acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0;

    for (int d0 = 0; d0 < DW; d0 += kDepth) {
      __syncthreads();  // the previous step's reads of qs/ct are done
      for (int e = tid; e < TQ * kDepth; e += kThreads) {
        const int r = e / kDepth, f = e % kDepth;
        const int gq = q0 + r, gw = d0 + f;
        const bool in = gq < B && gw < DW;
        if constexpr (kOp == kInt8) {
          const int8_t* row = static_cast<const int8_t*>(qv) + (size_t)gq * D;
          qs[f * QS + r] = in ? int8_word(row, gw, D, aligned) : 0;
        } else {
          const float* q = static_cast<const float*>(qv);
          qs[f * QS + r] = operand<kOp>(in ? q[(size_t)gq * D + gw] : 0.f);
        }
      }
      for (int e = tid; e < kTileRows * kDepth; e += kThreads) {
        const int r = e / kDepth, f = e % kDepth;
        const int gr = t0 + r, gw = d0 + f;
        const bool in = gr < row_hi && gw < DW;
        if constexpr (kOp == kInt8) {
          const int8_t* row = static_cast<const int8_t*>(cv) + (size_t)gr * D;
          ct[f * CS + r] = in ? int8_word(row, gw, D, aligned) : 0;
        } else {
          const float* c = static_cast<const float*>(cv);
          ct[f * CS + r] = operand<kOp>(in ? c[(size_t)gr * D + gw] : 0.f);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int f = 0; f < kDepth; ++f) {
        T a[RQ], b[RC];
        load_vec<RQ>(qs + f * QS + ty * RQ, a);   // queries ty*RQ + i
        load_vec<RC>(ct + f * CS + tx * RC, b);   // rows tx*RC + j
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
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
        if constexpr (kOp == kInt8) {
          // exact: |dot| < 2^24 for D <= 1040; above, rounded once as the
          // plain version rounds its float64 sum
          dist = __fsub_rn(cp[gr], __fmul_rn(__int2float_rn(acc[i][j]), cs[gr]));
        } else if (mode == 0) {
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
  const void* q;
  const void* c;
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
template <int TQ, int RQ, int RC, int kOp>
cudaError_t blocks_per_sm(int w, int* out) {
  const size_t smem = smem_bytes<TQ>(w);
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_kernel<TQ, RQ, RC, kOp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, flat_topk_kernel<TQ, RQ, RC, kOp>, kThreads, smem);
}

template <int TQ, int RQ, int RC, int kOp>
cudaError_t launch(const Args& a) {
  const int w = buffer_width(a.k);
  const size_t smem = smem_bytes<TQ>(w);
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_kernel<TQ, RQ, RC, kOp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // rows per split: a whole number of tiles; trailing splits may be empty
  const int per = (a.N + a.splits - 1) / a.splits;
  const int rows = (per + kTileRows - 1) / kTileRows * kTileRows;
  // int8 rows are read a word at a time where every row starts 4-byte aligned
  const int aligned = kOp == kInt8 && a.D % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.q) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.c) % 4 == 0;
  const dim3 grid((a.B + TQ - 1) / TQ, a.splits);
  flat_topk_kernel<TQ, RQ, RC, kOp><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.c, a.qn, a.cp, a.cs, a.out_d, a.out_i, a.B, a.N, a.D, a.k,
      a.mode, rows, w, aligned);
  return cudaGetLastError();
}

template <int kOp>
cudaError_t occupancy(int k, int* per_sm) {
  const int w = buffer_width(k);
  switch (query_tile(k)) {
    case 64: return blocks_per_sm<64, 4, 4, kOp>(w, per_sm);
    case 32: return blocks_per_sm<32, 2, 4, kOp>(w, per_sm);
    case 16: return blocks_per_sm<16, 1, 4, kOp>(w, per_sm);
    default: return blocks_per_sm<8, 1, 2, kOp>(w, per_sm);
  }
}

template <int kOp>
cudaError_t launch_op(const Args& a) {
  switch (query_tile(a.k)) {
    case 64: return launch<64, 4, 4, kOp>(a);
    case 32: return launch<32, 2, 4, kOp>(a);
    case 16: return launch<16, 1, 4, kOp>(a);
    default: return launch<8, 1, 2, kOp>(a);
  }
}

}  // namespace

extern "C" {

int flat_topk_max_k() { return kMaxK; }

// How many corpus splits to give the launcher on card `device`: as many as
// keep query tiles x splits within one wave of resident blocks, at least
// 8 tiles of corpus rows per split, at most kMaxSplits, at least 1.
// `op` selects the operand mode (0 f32, 1 bf16, 2 int8), whose instance
// may hold other registers. Returns -(CUDA error) if the card cannot be
// queried.
int flat_topk_splits(int B, int N, int k, int op, int device) {
  if (k < 1 || k > kMaxK || B < 1 || op < kF32 || op > kInt8) return 1;
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = op == kInt8   ? occupancy<kInt8>(k, &per_sm)
          : op == kBf16 ? occupancy<kBf16>(k, &per_sm)
                        : occupancy<kF32>(k, &per_sm);
  }
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

// q [B, D], c [N, D]: f32 (op 0: exact operands; 1: bf16-rounded) or int8
// (op 2). qn [B] f32 (read for l2), cp [N] f32, cs [N] f32 (read for cosine,
// and for int8 as the corpus scales), out_d/out_i [splits, B, k] f32/int32;
// all contiguous, on card `device`. mode: 0 l2, 1 cosine, 2 inner product
// (int8: 1 or 2, the same rank-only tile).
int flat_topk_launch(const void* q, const void* c, const void* qn,
                     const void* cp, const void* cs, void* out_d, void* out_i,
                     int B, int N, int D, int k, int mode, int op, int splits,
                     int device, void* stream) {
  if (B < 1 || N < 0 || D < 1 || k < 1 || k > kMaxK || mode < 0 ||
      mode > 2 || op < kF32 || op > kInt8 || (op == kInt8 && mode == 0) ||
      splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, c, static_cast<const float*>(qn),
               static_cast<const float*>(cp), static_cast<const float*>(cs),
               static_cast<float*>(out_d), static_cast<int*>(out_i),
               B, N, D, k, mode, splits, static_cast<cudaStream_t>(stream)};
  err = op == kInt8   ? launch_op<kInt8>(a)
        : op == kBf16 ? launch_op<kBf16>(a)
                      : launch_op<kF32>(a);
  return static_cast<int>(err);
}

}  // extern "C"
