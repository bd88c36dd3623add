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
// bytes of bf16 ones. What the design does
// about it:
//   - One block per query, 8 warps. The query row is read once into shared
//     memory as f32; each warp walks rows j = warp, warp + 8, ... of the
//     query's E*R0 rows, so E blocks' worth of rows share one query load.
//   - One warp per row: lanes read the row with 16-byte loads, neighbouring
//     lanes on neighbouring addresses (a 768-byte bf16 row at D=384 is 48
//     loads, fully coalesced), when every row starts 16-byte aligned (base
//     aligned and D*itemsize a multiple of 16). Otherwise lanes read single
//     elements, still coalesced; no shape is refused or padded.
//   - f32 accumulation with fmaf, one warp-shuffle reduction per row.
//   - A dead pick costs one id read: the TPU kernel's per-pick skip.
// There is no id budget or chunking as on the TPU (pallas_beam.py:187-207):
// each block reads its own ids. Overlapping the loads of the next rows with
// the reduction of this one (cp.async or TMA pipelining) is later work.
//
// Top-m mode (`beam_topm`). Replaces: pallas_beam.py `_beam_topm_kernel`
// (:214-312), launched through `gather_block_topm` (:315-419, pallas_call
// at :373), for f32 and bf16 blocks. The same one-block-per-query,
// one-warp-per-row gather and dot (`row_dot`), then in the kernel:
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr float kBig = 3.0e38f;      // the top-m mask, ops/beam.py BIG

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// Four packed words as floats: 4 f32, 8 bf16 or 16 int8 (little-endian:
// the low half, or byte, of each word is the lower element).
__device__ __forceinline__ void unpack(const uint4& w, float* out,
                                       const float*) {
  out[0] = __uint_as_float(w.x); out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z); out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float* out,
                                       const int8_t*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[4 * i + b] = static_cast<float>(static_cast<int8_t>(u[i] >> (8 * b)));
}

// One warp's dot of the f32 query in shared memory with one stored row, and
// the row's squared norm, summed in f32 with fmaf; every lane returns the
// warp's totals. `vec`: 16-byte loads (the row starts 16-byte aligned and
// D * sizeof(T) is a multiple of 16), else single elements.
template <typename T>
__device__ __forceinline__ void row_dot(const T* __restrict__ row,
                                        const float* qs, int D, int vec,
                                        int lane, float& dot, float& sq) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  dot = 0.f;
  sq = 0.f;
  if (vec) {
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    const int nvec = D / kVec;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float x[kVec];
      unpack(__ldg(rv + v), x, row);
      const float4* qv = reinterpret_cast<const float4*>(qs + v * kVec);
#pragma unroll
      for (int h = 0; h < kVec / 4; ++h) {
        const float4 qq = qv[h];
        dot = fmaf(x[4 * h], qq.x, dot);
        dot = fmaf(x[4 * h + 1], qq.y, dot);
        dot = fmaf(x[4 * h + 2], qq.z, dot);
        dot = fmaf(x[4 * h + 3], qq.w, dot);
#pragma unroll
        for (int t = 0; t < 4; ++t) sq = fmaf(x[4 * h + t], x[4 * h + t], sq);
      }
    }
  } else {
    for (int f = lane; f < D; f += 32) {
      const float x = to_f32(row[f]);
      dot = fmaf(x, qs[f], dot);
      sq = fmaf(x, x, sq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_dots_kernel(const float* __restrict__ q,     // [B, D]
                 const int* __restrict__ idx,     // [B, E]
                 const T* __restrict__ packed,    // [cap, R0, D]
                 float* __restrict__ dots,        // [B, E*R0]
                 float* __restrict__ cn2,         // [B, E*R0]
                 int E, int R0, int D, int cap, int vec) {
  extern __shared__ __align__(16) float qs[];     // [D]
  const int b = blockIdx.x;
  for (int f = threadIdx.x; f < D; f += kThreads) qs[f] = q[(size_t)b * D + f];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = E * R0;
  for (int j = warp; j < rows; j += kWarps) {
    const int pick = idx[(size_t)b * E + j / R0];  // uniform across the warp
    float dot = 0.f, sq = 0.f;
    if (pick >= cap) {
      dot = sq = CUDART_NAN_F;
    } else if (pick >= 0) {
      row_dot(packed + ((size_t)pick * R0 + j % R0) * D, qs, D, vec, lane,
              dot, sq);
    }
    if (lane == 0) {
      dots[(size_t)b * rows + j] = dot;
      cn2[(size_t)b * rows + j] = sq;
    }
  }
}

// The metric over one row's (dot, cn2), as ops/beam.py packed_distances
// writes it, one rounding per step (no FMA contraction): l2
// max((qn2 + cn2) - 2 dot, 0); cosine 1 - dot / max(|q||c|, 1e-30), similarity
// 0 below the guard; inner product -dot. mode: 0 l2, 1 cosine, 2 ip.
__device__ __forceinline__ float metric_distance(float dot, float cn2,
                                                 float qn2, int mode) {
  if (mode == 2) return -dot;
  if (mode == 0)
    return fmaxf(__fsub_rn(__fadd_rn(qn2, cn2), __fmul_rn(2.f, dot)), 0.f);
  const float denom = __fmul_rn(sqrtf(qn2), sqrtf(cn2));
  const float sim = denom < 1e-30f ? 0.f : __fdiv_rn(dot, fmaxf(denom, 1e-30f));
  return __fsub_rn(1.f, sim);
}

// Top-m mode: the same per-row gather and dot, then the metric, the penalty
// and, per pick, m rounds of min / lowest-index argmin / mask to kBig on its
// R0 distances, held in shared memory beside the query.
template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_topm_kernel(const float* __restrict__ q,     // [B, D]
                 const float* __restrict__ qn2,   // [B]
                 const int* __restrict__ idx,     // [B, E]
                 const T* __restrict__ packed,    // [cap, R0, D]
                 const float* __restrict__ pen,   // [B, E*R0]
                 float* __restrict__ od,          // [B, E, M]
                 int* __restrict__ ol,            // [B, E, M]
                 int E, int R0, int D, int cap, int M, int mode, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (D + 3) & ~3;  // keeps dist 16-byte aligned; unused tail
  float* qs = smem;             // [D]
  float* dist = smem + dp;      // [E*R0]
  const int b = blockIdx.x;
  for (int f = threadIdx.x; f < D; f += kThreads) qs[f] = q[(size_t)b * D + f];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = E * R0;
  const float q2 = qn2[b];
  for (int j = warp; j < rows; j += kWarps) {
    const int pick = idx[(size_t)b * E + j / R0];  // uniform across the warp
    if (pick < 0 || pick >= cap) continue;         // no load: see below
    float dot, sq;
    row_dot(packed + ((size_t)pick * R0 + j % R0) * D, qs, D, vec, lane, dot,
            sq);
    if (lane == 0)
      dist[j] = __fadd_rn(metric_distance(dot, sq, q2, mode),
                          pen[(size_t)b * rows + j]);
  }
  __syncthreads();

  for (int e = warp; e < E; e += kWarps) {
    const int pick = idx[(size_t)b * E + e];
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

template <typename T>
cudaError_t launch(const float* q, const int* idx, const void* packed,
                   float* dots, float* cn2, int B, int E, int R0, int D,
                   int cap, cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  const cudaError_t err = allow_smem(beam_dots_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  beam_dots_kernel<T><<<B, kThreads, smem, stream>>>(
      q, idx, static_cast<const T*>(packed), dots, cn2, E, R0, D, cap,
      rows_vec<T>(packed, D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_topm(const float* q, const float* qn2, const int* idx,
                        const void* packed, const float* pen, float* od,
                        int* ol, int B, int E, int R0, int D, int cap, int M,
                        int mode, cudaStream_t stream) {
  const size_t smem = ((size_t)((D + 3) & ~3) + (size_t)E * R0) * sizeof(float);
  const cudaError_t err = allow_smem(beam_topm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  beam_topm_kernel<T><<<B, kThreads, smem, stream>>>(
      q, qn2, idx, static_cast<const T*>(packed), pen, od, ol, E, R0, D, cap,
      M, mode, rows_vec<T>(packed, D));
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
