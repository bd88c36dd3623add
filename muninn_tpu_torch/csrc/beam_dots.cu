// Gather + dots (and gather + distances + per-pick top-m) for the HNSW
// beam: for each (query, pick) read one
// contiguous [R0, D] block of the packed neighbour table and emit the
// query's dot with each row and the row's squared norm. The gathered blocks
// never reach device memory as a [B, E*R0, D] intermediate.
//
// Replaces: muninn_tpu/ops/pallas_beam.py `_beam_dots_kernel`
// (pallas_beam.py:46-114), launched through `gather_block_dots` (:117-211,
// pallas_call at :161), for f32, bf16 and int8 blocks. The int8 blocks of
// HNSW int8 guidance are multiplied as stored; the caller applies the
// per-neighbour dequantization scales in its epilogue (hnsw.py:369-373).
//
// Contract, as the TPU kernel's:
//   dots[b, j] = <q[b], packed[idx[b, j / R0]][j % R0]>
//   cn2[b, j]  = that row's squared norm, summed in f32 from stored values
//                (int8: integers below 2^24 for D <= 1040, so exact)
//   a dead pick (idx < 0) issues no load and writes exactly 0 to both.
// A pick at or above `cap` is a caller's fault: it reads nothing and
// writes NaN, so the fault shows in the results instead of reading past
// the table.
//
// What bounds it on an H100: device-memory bytes. Each call reads
// B*E*R0*D*itemsize of packed blocks (8,192 x 8 x 32 x 384 x 2 B = 1.6 GB
// per beam iteration at the HNSW bench shape, about 0.5 ms at 3.35 TB/s)
// and does 4 flops per element, far below the ridge; int8 blocks halve the
// bytes of bf16 ones. A block's rows are independent, so what keeps the
// card from its memory rate is rows in flight. What the design does about
// it:
//   - One block per query, 4 warps (more, smaller blocks an SM hide more
//     of each block's start and tail than 8 warps did:
//     tools/probes/beam_probe.py). The query row is read once into shared
//     memory as f32, and the query's E pick ids beside it (when they fit),
//     so no row waits on an id load.
//   - The rows go through block_rows.cuh: L lanes share a row, up to 8
//     16-byte loads a lane (4 lanes for an int8 row of D = 384, 8 for bf16,
//     16 for f32: every lane loads), a warp takes 32 / L rows of each of
//     two groups at once and issues all of their loads, neighbouring lanes
//     on neighbouring addresses, before any multiply-add; one shuffle tree
//     of log2(L) steps then sums them all. Rows that are not 16-byte aligned (base unaligned or
//     D*itemsize not a multiple of 16) are read one element a lane; no
//     shape is refused or padded.
//   - f32 accumulation with fmaf; int8 elements become floats by a byte
//     permute and one subtraction, their squared norms are __dp4a sums.
//   - A dead pick issues no load.
// There is no id budget or chunking as on the TPU (pallas_beam.py:187-207):
// each block reads its own ids.
//
// Top-m mode (`beam_topm`). Replaces: pallas_beam.py `_beam_topm_kernel`
// (:214-312), launched through `gather_block_topm` (:315-419, pallas_call
// at :373), for f32 and bf16 blocks. The same gather and dots, then in the
// kernel:
//   dist[b, e, r] = metric(dot, cn2, qn2[b]) + pen[b, e*R0 + r]
// with the steps of ops/beam.py packed_distances, each rounded once
// (__fadd_rn & co., so no FMA contraction moves a rounding), kept in shared
// memory beside the query; then one warp per pick runs M rounds of min,
// lowest-index argmin (warp shuffles over (value, index)) and mask to
// kBig, the TPU kernel's selection, so kernel and plain pick the same local
// indices wherever the distances agree. Out: od [B, E, M] ascending, ol
// [B, E, M] local row indices. A dead pick issues no load and writes
// (kBig, 0); a pick at or above `cap` writes (NaN, 0). Bound, as the gather:
// bytes of the live picks' blocks; the per-pick selection is M * R0/32
// shared reads and 10 shuffles per warp and round, small beside a block's
// R0 * D * itemsize bytes.
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;           // row groups a warp loads at once
constexpr int kUnits = 8;            // 16-byte loads a lane and row at once
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr float kBig = 3.0e38f;      // the top-m mask, ops/beam.py BIG

// A block's query in shared memory (`qs`, D floats padded to 4) and, when
// `hoist`, its E pick ids after it; returns where the picks are read.
__device__ __forceinline__ const int* stage_query(const float* __restrict__ q,
                                                  const int* __restrict__ idx,
                                                  float* qs, int* pk, int D,
                                                  int E, int hoist) {
  const size_t b = blockIdx.x;
  for (int f = threadIdx.x; f < D; f += kThreads) qs[f] = q[b * D + f];
  if (hoist)
    for (int i = threadIdx.x; i < E; i += kThreads) pk[i] = idx[b * E + i];
  __syncthreads();
  return hoist ? pk : idx + b * E;
}

// j / R0 for a block's rows without a division: the high word of j times
// the launcher's m = floor((2^64 - 1) / R0) + 1, exact for every j < 2^31.
__device__ __forceinline__ int pick_of(int j, int R0, unsigned long long m) {
  return R0 == 1 ? j : (int)__umul64hi((unsigned long long)j, m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_dots_kernel(const float* __restrict__ q,     // [B, D]
                 const int* __restrict__ idx,     // [B, E]
                 const T* __restrict__ packed,    // [cap, R0, D]
                 float* __restrict__ dots,        // [B, E*R0]
                 float* __restrict__ cn2,         // [B, E*R0]
                 int E, int R0, int D, int cap, int vec, int lg, int hoist,
                 unsigned long long m) {
  extern __shared__ __align__(16) float smem[];   // query [D], picks [E]
  const int dp = (D + 3) & ~3;
  const int* picks = stage_query(q, idx, smem, reinterpret_cast<int*>(smem + dp),
                                 D, E, hoist);
  const int rows = E * R0;
  const size_t out = (size_t)blockIdx.x * rows;
  const int units = vec ? D / (16 / (int)sizeof(T)) : D;
  block_rows::score_rows<T, kGroups, kUnits>(
      smem, rows, units, lg, vec, threadIdx.x >> 5, kWarps, threadIdx.x & 31,
      [&](int j) -> const T* {
        const int i = pick_of(j, R0, m), p = picks[i];
        return p < 0 || p >= cap ? nullptr
                                 : packed + ((size_t)p * R0 + (j - i * R0)) * D;
      },
      [&](int j, float dot, float sq, bool loaded) {
        if (!loaded && picks[pick_of(j, R0, m)] >= cap) dot = sq = CUDART_NAN_F;
        dots[out + j] = dot;
        cn2[out + j] = sq;
      });
}

// Top-m mode: the same gather and dots, then the metric, the penalty and,
// per pick, m rounds of min / lowest-index argmin / mask to kBig on its R0
// distances, held in shared memory beside the query.
template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_topm_kernel(const float* __restrict__ q,     // [B, D]
                 const float* __restrict__ qn2,   // [B]
                 const int* __restrict__ idx,     // [B, E]
                 const T* __restrict__ packed,    // [cap, R0, D]
                 const float* __restrict__ pen,   // [B, E*R0]
                 float* __restrict__ od,          // [B, E, M]
                 int* __restrict__ ol,            // [B, E, M]
                 int E, int R0, int D, int cap, int M, int mode, int vec,
                 int lg, int hoist, unsigned long long m) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (D + 3) & ~3;  // keeps dist 16-byte aligned; unused tail
  const int rows = E * R0;
  float* dist = smem + dp;      // [E*R0], then the picks [E]
  const int* picks = stage_query(q, idx, smem, reinterpret_cast<int*>(dist + rows),
                                 D, E, hoist);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float q2 = qn2[b];
  const int units = vec ? D / (16 / (int)sizeof(T)) : D;
  block_rows::score_rows<T, kGroups, kUnits>(
      smem, rows, units, lg, vec, warp, kWarps, lane,
      [&](int j) -> const T* {
        const int i = pick_of(j, R0, m), p = picks[i];
        return p < 0 || p >= cap ? nullptr
                                 : packed + ((size_t)p * R0 + (j - i * R0)) * D;
      },
      [&](int j, float dot, float sq, bool loaded) {
        if (loaded)  // a dead or out-of-range pick has no distance: see below
          dist[j] = __fadd_rn(block_rows::metric_distance(dot, sq, q2, mode),
                              pen[(size_t)b * rows + j]);
      });
  __syncthreads();

  for (int e = warp; e < E; e += kWarps) {
    const int pick = picks[e];
    float* out_d = od + ((size_t)b * E + e) * M;
    int* out_l = ol + ((size_t)b * E + e) * M;
    if (pick < 0 || pick >= cap) {  // dead: (kBig, 0); out of range: (NaN, 0)
      const float fill = pick < 0 ? kBig : CUDART_NAN_F;
      for (int k = lane; k < M; k += 32) {
        out_d[k] = fill;
        out_l[k] = 0;
      }
      continue;
    }
    float* dd = dist + e * R0;
    for (int k = 0; k < M; ++k) {
      // the lane's best (value, index) over r = lane, lane + 32, ...; then
      // the warp's, lower index on equal values (an all-NaN row keeps R0)
      float v = CUDART_INF_F;
      int at = R0;
      for (int r = lane; r < R0; r += 32) {
        const float x = dd[r];
        if (x < v || (x == v && r < at)) {
          v = x;
          at = r;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oa = __shfl_xor_sync(0xffffffffu, at, off);
        if (ov < v || (ov == v && oa < at)) {
          v = ov;
          at = oa;
        }
      }
      if (lane == 0) {
        out_d[k] = v;
        out_l[k] = at;
        if (at < R0) dd[at] = kBig;
      }
      __syncwarp();
    }
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory where that is
// above the 48 KB default; refuse more than a block has.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int rows_vec(const void* packed, int D) {
  return (reinterpret_cast<uintptr_t>(packed) % 16 == 0) &&
         ((size_t)D * sizeof(T)) % 16 == 0;
}

// pick_of's multiplier for R0 > 1.
inline unsigned long long reciprocal(int R0) {
  return R0 > 1 ? ~0ull / (unsigned long long)R0 + 1 : 0;
}

// The row geometry of block_rows.cuh: (vec, log2 of the lanes a row).
template <typename T>
void geometry(const void* packed, int D, int& vec, int& lg) {
  vec = rows_vec<T>(packed, D);
  lg = block_rows::lanes_log2(vec ? D / (16 / (int)sizeof(T)) : D, kUnits);
}

// Shared memory of a block: `words` of it before the picks, and the E pick
// ids after them where they fit (`hoist`), else read from idx.
inline size_t with_picks(size_t words, int E, int& hoist) {
  hoist = (words + E) * sizeof(float) <= kMaxSmem;
  return (words + (hoist ? E : 0)) * sizeof(float);
}

template <typename T>
cudaError_t launch(const float* q, const int* idx, const void* packed,
                   float* dots, float* cn2, int B, int E, int R0, int D,
                   int cap, cudaStream_t stream) {
  int vec, lg, hoist;
  geometry<T>(packed, D, vec, lg);
  const size_t smem = with_picks((size_t)((D + 3) & ~3), E, hoist);
  const cudaError_t err = allow_smem(beam_dots_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  beam_dots_kernel<T><<<B, kThreads, smem, stream>>>(
      q, idx, static_cast<const T*>(packed), dots, cn2, E, R0, D, cap, vec, lg,
      hoist, reciprocal(R0));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_topm(const float* q, const float* qn2, const int* idx,
                        const void* packed, const float* pen, float* od,
                        int* ol, int B, int E, int R0, int D, int cap, int M,
                        int mode, cudaStream_t stream) {
  int vec, lg, hoist;
  geometry<T>(packed, D, vec, lg);
  const size_t smem =
      with_picks((size_t)((D + 3) & ~3) + (size_t)E * R0, E, hoist);
  const cudaError_t err = allow_smem(beam_topm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  beam_topm_kernel<T><<<B, kThreads, smem, stream>>>(
      q, qn2, idx, static_cast<const T*>(packed), pen, od, ol, E, R0, D, cap,
      M, mode, vec, lg, hoist, reciprocal(R0));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* beam_dots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, D] f32, idx [B, E] int32, packed [cap, R0, D] (dtype 0: f32,
// 1: bf16, 2: int8), dots/cn2 [B, E*R0] f32; all contiguous, on card
// `device`.
int beam_dots(const void* q, const void* idx, const void* packed, void* dots,
              void* cn2, int B, int E, int R0, int D, int cap, int dtype,
              int device, void* stream) {
  if (B < 1 || E < 1 || R0 < 1 || D < 1 || cap < 0 || dtype < 0 ||
      dtype > 2 || (long long)E * R0 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qf = static_cast<const float*>(q);
  const int* ix = static_cast<const int*>(idx);
  float* od = static_cast<float*>(dots);
  float* oc = static_cast<float*>(cn2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch<float>(qf, ix, packed, od, oc, B, E, R0, D, cap, st); break;
    case 1: err = launch<__nv_bfloat16>(qf, ix, packed, od, oc, B, E, R0, D, cap, st); break;
    default: err = launch<int8_t>(qf, ix, packed, od, oc, B, E, R0, D, cap, st); break;
  }
  return static_cast<int>(err);
}

// q [B, D] f32, qn2 [B] f32 (the queries' squared norms), idx [B, E] int32,
// packed [cap, R0, D] (dtype 0: f32, 1: bf16), pen [B, E*R0] f32, od [B, E, M]
// f32, ol [B, E, M] int32; mode 0 l2, 1 cosine, 2 inner product; all
// contiguous, on card `device`.
int beam_topm(const void* q, const void* qn2, const void* idx,
              const void* packed, const void* pen, void* od, void* ol, int B,
              int E, int R0, int D, int cap, int M, int dtype, int mode,
              int device, void* stream) {
  if (B < 1 || E < 1 || R0 < 1 || D < 1 || cap < 0 || M < 1 || M > R0 ||
      dtype < 0 || dtype > 1 || mode < 0 || mode > 2 ||
      (long long)E * R0 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qf = static_cast<const float*>(q);
  const float* q2 = static_cast<const float*>(qn2);
  const int* ix = static_cast<const int*>(idx);
  const float* pf = static_cast<const float*>(pen);
  float* odf = static_cast<float*>(od);
  int* oli = static_cast<int*>(ol);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_topm<float>(qf, q2, ix, packed, pf, odf, oli, B, E, R0, D, cap,
                             M, mode, st);
  else
    err = launch_topm<__nv_bfloat16>(qf, q2, ix, packed, pf, odf, oli, B, E,
                                     R0, D, cap, M, mode, st);
  return static_cast<int>(err);
}

}  // extern "C"
