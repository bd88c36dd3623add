// The whole HNSW level-0 beam of one query in one block: pick the best E
// unexpanded entries, read their neighbour rows, drop candidates already in
// the beam or repeated within the step, score the rest from the picks'
// packed bf16 blocks, merge one top-ef, fill-aware patience; the beam never
// leaves shared memory until the query is done.
//
// Replaces: muninn_tpu/ops/pallas_beam_loop.py `_beam_loop_kernel`
// (pallas_beam_loop.py:91-311), launched through `beam_loop` (:321-415,
// pallas_call at :378). Its steps, and those of the fused branch of
// muninn_tpu/index/hnsw.py `_beam_search_level0` (:271-416), op for op:
//   cand = expanded | slot < 0 ? inf : beam_d; picks = the e smallest of
//     cand by (distance, position), valid where cand < inf;
//   live = any valid pick && stall < patience; expanded |= valid picks;
//   candidates = neighbors0 rows of the valid picks (pick-major); a
//     candidate with id < 0, an id in the beam, or the id of an earlier
//     candidate of the step is dropped (inf, -1);
//   distance = the metric over (dot, cn2) of the packed row and qn2, each
//     step rounded once as ops/beam.py packed_distances writes it;
//   new beam = the ef smallest of [beam | candidates] by (distance,
//     position), (inf, -1, unexpanded) where fewer are finite;
//   improved = new_d[ef-1] < old_d[ef-1] || #new slots >= 0 > #old;
//   stall = live ? (improved ? 0 : stall + #valid picks) : stall.
// The TPU kernel reads each candidate id from bf16 byte lanes packed into the
// vector block (pack_wide); here a thread reads neighbors0 [cap, R0] itself,
// so the blocks are the fused path's packed [cap, R0, D] bf16 table.
//
// Early exit: a query that is not live at a step never changes again (no
// candidates, stall frozen, and from the second step on its beam is already
// the sorted result of a merge), so its block stops there; the result equals
// running all max_iters steps, as the TPU kernel does.
//
// What bounds it on an H100: on paper device-memory bytes, the neighbour ids
// (E*R0*4 B per step) and the fresh candidates' rows (D*2 B each; a dropped
// candidate's row is never read). In practice each step is a chain of
// block-wide phases (pick, ids, dedup, score, merge, counts) separated by
// barriers, with O(ef^2 + E*R0*(ef + E*R0)) shared-memory compares for the
// rank-counting pick, dedup and merge, so one block's time is latency; many
// blocks per SM (one per query, 256 threads, a few KB of shared memory each)
// hide part of it. The scoring is beam_dots' one warp per row with 16-byte
// loads when rows are aligned.
//
// Limits (shared memory, 4 bytes a word): the query (D rounded up to 4),
// two beams of ef (distance, slot, flag), E*R0 candidates (distance, slot,
// keep) and E picks must fit 232,448 bytes; ops/beam_loop.py also caps
// ef <= 1024 and E*R0 <= 4096.
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

// One warp's dot of the f32 query in shared memory with one bf16 row, and
// the row's squared norm, summed in f32 with fmaf; every lane returns the
// totals. `vec`: 16-byte loads of 8 bf16, else single elements.
__device__ __forceinline__ void row_dot(const __nv_bfloat16* __restrict__ row,
                                        const float* qs, int D, int vec,
                                        int lane, float& dot, float& sq) {
  dot = 0.f;
  sq = 0.f;
  if (vec) {
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    const int nvec = D / 8;
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      const uint4 w = __ldg(rv + v);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
      const float4* qv = reinterpret_cast<const float4*>(qs + v * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 qq = qv[h];
        // the low half of each word is the lower element (little-endian)
        const float x0 = __uint_as_float(u[2 * h] << 16);
        const float x1 = __uint_as_float(u[2 * h] & 0xffff0000u);
        const float x2 = __uint_as_float(u[2 * h + 1] << 16);
        const float x3 = __uint_as_float(u[2 * h + 1] & 0xffff0000u);
        dot = fmaf(x0, qq.x, dot);
        dot = fmaf(x1, qq.y, dot);
        dot = fmaf(x2, qq.z, dot);
        dot = fmaf(x3, qq.w, dot);
        sq = fmaf(x0, x0, sq);
        sq = fmaf(x1, x1, sq);
        sq = fmaf(x2, x2, sq);
        sq = fmaf(x3, x3, sq);
      }
    }
  } else {
    for (int f = lane; f < D; f += 32) {
      const float x = __bfloat162float(row[f]);
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

// ops/beam.py packed_distances, one rounding per step. mode: 0 l2,
// 1 cosine, 2 inner product.
__device__ __forceinline__ float metric_distance(float dot, float cn2,
                                                 float qn2, int mode) {
  if (mode == 2) return -dot;
  if (mode == 0)
    return fmaxf(__fsub_rn(__fadd_rn(qn2, cn2), __fmul_rn(2.f, dot)), 0.f);
  const float denom = __fmul_rn(sqrtf(qn2), sqrtf(cn2));
  const float sim = denom < 1e-30f ? 0.f : __fdiv_rn(dot, fmaxf(denom, 1e-30f));
  return __fsub_rn(1.f, sim);
}

// How many of a[0..n) are >= 0, across the block (every thread gets it).
__device__ __forceinline__ int count_valid(const int* a, int n) {
  int c = 0;
  for (int base = 0; base < n; base += kThreads)
    c += __syncthreads_count(base + (int)threadIdx.x < n &&
                             a[base + threadIdx.x] >= 0);
  return c;
}

__global__ void __launch_bounds__(kThreads)
beam_loop_kernel(const float* __restrict__ q,        // [B, D]
                 const float* __restrict__ qn2,      // [B]
                 const float* __restrict__ init_d,   // [B, ef]
                 const int* __restrict__ init_i,     // [B, ef]
                 const __nv_bfloat16* __restrict__ packed,  // [cap, R0, D]
                 const int* __restrict__ nbrs0,      // [cap, R0]
                 float* __restrict__ out_d,          // [B, ef]
                 int* __restrict__ out_i,            // [B, ef]
                 int D, int R0, int ef, int E, int patience, int max_iters,
                 int mode, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int C = E * R0;
  float* qs = smem;                                    // [D], padded to 4
  float* bd = qs + ((D + 3) & ~3);                     // beam: distance
  int* bi = reinterpret_cast<int*>(bd + ef);           //       slot
  int* bx = bi + ef;                                   //       expanded
  float* nd = reinterpret_cast<float*>(bx + ef);       // next beam
  int* ni = reinterpret_cast<int*>(nd + ef);
  int* nx = ni + ef;
  float* cd = reinterpret_cast<float*>(nx + ef);       // candidates
  int* ci = reinterpret_cast<int*>(cd + C);
  int* keep = ci + C;
  int* pk = keep + C;                                  // [E] pick positions

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  for (int f = tid; f < D; f += kThreads) qs[f] = q[b * D + f];
  for (int p = tid; p < ef; p += kThreads) {
    bd[p] = init_d[b * ef + p];
    bi[p] = init_i[b * ef + p];
    bx[p] = 0;
  }
  const float q2 = qn2[b];
  int stall = 0;  // the same in every thread
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // pick: rank each unexpanded live entry among the others by (distance,
    // position); ranks below E name the picks, in order
    for (int i = tid; i < E; i += kThreads) pk[i] = -1;
    __syncthreads();
    for (int p = tid; p < ef; p += kThreads) {
      const float d = bd[p];
      if (bx[p] || bi[p] < 0 || !(d < CUDART_INF_F)) continue;
      int rank = 0;
      for (int o = 0; o < ef && rank < E; ++o) {
        const float od = bd[o];
        rank += !bx[o] && bi[o] >= 0 && (od < d || (od == d && o < p));
      }
      if (rank < E) pk[rank] = p;
    }
    __syncthreads();
    const int npick = count_valid(pk, E);
    const bool live = npick > 0 && stall < patience;
    if (!live && it > 0) break;  // uniform: see the header

    // the picks' neighbour ids, pick-major; picks marked expanded
    const int nlive = live ? npick : 0;
    for (int i = tid; i < nlive; i += kThreads) bx[pk[i]] = 1;
    for (int j = tid; j < C; j += kThreads) {
      const int i = j / R0;
      ci[j] = i < nlive ? nbrs0[(size_t)bi[pk[i]] * R0 + (j - i * R0)] : -1;
      cd[j] = CUDART_INF_F;
    }
    for (int p = tid; p < ef; p += kThreads) {
      nd[p] = CUDART_INF_F;
      ni[p] = -1;
      nx[p] = 0;
    }
    __syncthreads();

    // dedup: drop ids in the beam and repeats of an earlier candidate
    for (int j = tid; j < C; j += kThreads) {
      const int id = ci[j];
      bool k = id >= 0;
      for (int p = 0; k && p < ef; ++p) k = bi[p] != id;
      for (int o = 0; k && o < j; ++o) k = ci[o] != id;
      keep[j] = k;
    }
    __syncthreads();

    // score the kept candidates, one warp per row of the pick's block
    for (int j = warp; j < C; j += kWarps) {
      if (!keep[j]) continue;  // uniform across the warp
      const int i = j / R0;
      float dot, sq;
      row_dot(packed + ((size_t)bi[pk[i]] * R0 + (j - i * R0)) * D, qs, D, vec,
              lane, dot, sq);
      if (lane == 0) cd[j] = metric_distance(dot, sq, q2, mode);
    }
    __syncthreads();

    // merge: rank each finite entry of [beam | candidates] by (distance,
    // position); ranks below ef form the next beam
    for (int w = tid; w < ef + C; w += kThreads) {
      const bool old = w < ef;
      const float d = old ? bd[w] : cd[w - ef];
      if (!(d < CUDART_INF_F)) continue;
      int rank = 0;
      for (int o = 0; o < ef && rank < ef; ++o) {
        const float od = bd[o];
        rank += od < d || (od == d && o < w);
      }
      for (int o = 0; o < C && rank < ef; ++o) {
        const float od = cd[o];
        rank += od < d || (od == d && ef + o < w);
      }
      if (rank < ef) {
        nd[rank] = d;
        ni[rank] = old ? bi[w] : ci[w - ef];
        nx[rank] = old ? bx[w] : 0;
      }
    }
    __syncthreads();

    // fill-aware improvement; patience counts expansions
    const int had = count_valid(bi, ef);
    const int has = count_valid(ni, ef);
    if (live) stall = (nd[ef - 1] < bd[ef - 1] || has > had) ? 0 : stall + npick;
    float* tf = bd; bd = nd; nd = tf;
    int* ti = bi; bi = ni; ni = ti;
    ti = bx; bx = nx; nx = ti;
    __syncthreads();  // every read of the old beam is done before it is reused
  }
  for (int p = tid; p < ef; p += kThreads) {
    out_d[b * ef + p] = bd[p];
    out_i[b * ef + p] = bi[p];
  }
}

}  // namespace

extern "C" {

const char* beam_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, D] f32, qn2 [B] f32 (the queries' squared norms), init_d [B, ef] f32,
// init_i [B, ef] int32, packed [cap, R0, D] bf16, nbrs0 [cap, R0] int32,
// out_d [B, ef] f32, out_i [B, ef] int32; E = min(expand, ef) picks a step;
// mode 0 l2, 1 cosine, 2 inner product; all contiguous, on card `device`.
int beam_loop(const void* q, const void* qn2, const void* init_d,
              const void* init_i, const void* packed, const void* nbrs0,
              void* out_d, void* out_i, int B, int D, int R0, int cap, int ef,
              int E, int patience, int max_iters, int mode, int device,
              void* stream) {
  if (B < 1 || D < 1 || R0 < 1 || cap < 0 || ef < 1 || E < 1 || E > ef ||
      patience < 1 || max_iters < 0 || mode < 0 || mode > 2 ||
      (long long)E * R0 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      ((size_t)((D + 3) & ~3) + 6 * (size_t)ef + 3 * (size_t)E * R0 + E) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(beam_loop_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && D % 8 == 0;
  beam_loop_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qn2),
      static_cast<const float*>(init_d), static_cast<const int*>(init_i),
      static_cast<const __nv_bfloat16*>(packed),
      static_cast<const int*>(nbrs0), static_cast<float*>(out_d),
      static_cast<int*>(out_i), D, R0, ef, E, patience, max_iters, mode, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
