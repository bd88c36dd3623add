// One step of the fused HNSW level-0 beam for every query of a chunk, one
// block a query: the whole body of an iteration of index/hnsw.py
// `_beam_search_level0`'s loop in one launch, bit for bit what the eager
// step (ops/beam_step.py `beam_step_plain`, over the `beam_dots` kernel on
// the card) computes.
//
// Replaces: muninn_tpu/ops/pallas_beam.py `_beam_dots_kernel`
// (pallas_beam.py:46-114, launched through `gather_block_dots`, pallas_call
// at :161), together with the XLA glue of the fused branch of
// muninn_tpu/index/hnsw.py `_beam_search_level0` (:271-416) around it: the
// picks, the neighbour ids, the dedup, the metric epilogue, the merge and
// the patience update. In the port that glue was about 85 eager launches a
// step, two of them quadratic compares ([B, E*R0, ef] against the beam,
// [B, E*R0, E*R0] within the step).
//
// A step, op for op as the eager one (csrc/beam_loop.cu's header states the
// same steps):
//   cand = expanded | slot < 0 ? inf : beam_d; picks = the E smallest of
//     cand by (distance, position), valid where cand < inf;
//   live = any valid pick && stall < patience; expanded |= live picks;
//   candidates = neighbors0 rows of the live picks (pick-major); a
//     candidate with id < 0, an id in the beam, or (with dedup) the id of
//     an earlier candidate of the step is dropped (inf, -1);
//   distance = the metric over (dot, cn2) of the packed row and qn2; for
//     int8 blocks dot * ps and cn2 * ps * ps first, ps the neighbour's
//     scale; each step rounded once as ops/beam.py packed_distances writes
//     it, the rows summed through block_rows.cuh with the lanes a row that
//     csrc/beam_dots.cu gives them, so every dot and norm equals its own;
//   new beam = the ef smallest of [beam | candidates] by (distance,
//     position), slot -1 where the distance is infinite, unexpanded where
//     the slot is -1;
//   improved = new_d[ef-1] < old_d[ef-1] || #new slots >= 0 > #old;
//   stall = live ? (improved ? 0 : stall + #live picks) : stall;
//   go on = any unexpanded slot >= 0 in the new beam && stall < patience,
//     OR-ed into `flag` (the host reads one flag a step, zeroed once a
//     beam).
// The state (distances, slots, flags [B, ef], stall [B]) is read from
// device memory at the start and written back in place at the end. The
// beam a merge writes is sorted; the caller's first beam is not, so a
// block first checks its beam's order and ranks it once where it is out of
// order, which reproduces the eager sort's picks and tie order; `old_d`
// and the slot count are read from the beam as stored. Distances are never
// NaN (finite queries and rows), as for the eager step's kernels.
//
// What bounds it on an H100: device-memory bytes, the live picks' neighbour
// ids (E*R0*4 B a query), the kept candidates' rows (D * itemsize each; a
// dropped candidate's row is never read) and the state in and out
// (ef * 9 + 8 B a query each way). A block's phases are a chain of barriers
// and two dependent round trips (the ids, then the rows), so what keeps the
// card from its memory rate is latency, hidden by the other blocks of an
// SM. The design does about it what beam_loop.cu does, through the same
// phases (csrc/beam_phases.cuh): an O(1) hash dedup, the kept candidates
// compacted and prefetched into L2, many rows a warp in flight, and only
// the contenders ranked and merged by binary searches; a query that is not
// live skips to the merge, which only restores its beam's order.
//
// Limits, as beam_loop's: shared memory (beam_phases.cuh `plan`): ef <=
// 1024 and E*R0 <= 4096 (ops/beam_step.py MAX_EF, MAX_CANDIDATES, which
// ops/beam_loop.py sets), where a block takes at most 192,640 bytes without
// the query; E*R0 <= 64 a thread for the dedup's bit masks. The caller
// (`_beam_search_level0`) runs the eager step outside them.
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "beam_phases.cuh"
#include "block_rows.cuh"

namespace {

using namespace beam_phases;

constexpr int kGroups = 2;  // row groups a warp scores at once
constexpr int kUnits = 8;   // 16-byte loads a lane and row: beam_dots.cu's,
                            // so each row takes its lanes and sum order

template <typename T, bool kQueryShared>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(const float* __restrict__ q,        // [B, D]
                 const float* __restrict__ qn2,      // [B]
                 float* __restrict__ beam_d,         // [B, ef], in place
                 int* __restrict__ beam_i,           // [B, ef]
                 uint8_t* __restrict__ expanded,     // [B, ef] bool
                 long long* __restrict__ stall_io,   // [B]
                 const T* __restrict__ packed,       // [cap, R0, D]
                 const float* __restrict__ pscales,  // [cap, R0] or null
                 const int* __restrict__ nbrs0,      // [cap, R0]
                 int* __restrict__ flag,             // [1] or null
                 int D, int R0, int ef, int E, int patience, int mode,
                 int dedup, int vec, int lg, int hlog) {
  extern __shared__ __align__(16) float smem[];
  const int C = E * R0, H = 1 << hlog;
  Smem s = carve(smem, kQueryShared ? (D + 3) & ~3 : 0, ef, C, E, H);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* qv = kQueryShared ? s.qs : q + b * D;
  if (kQueryShared)
    for (int f = tid; f < D; f += kThreads) s.qs[f] = q[b * D + f];
  float* bd = beam_d + b * ef;
  int* bi = beam_i + b * ef;
  uint8_t* bx = expanded + b * ef;
  for (int p = tid; p < ef; p += kThreads) {
    s.nd[p] = bd[p];
    s.ni[p] = bi[p];
    s.nx[p] = bx[p];
  }
  clear_hash(s, H);
  // finite entries, slots >= 0, and entries out of the merge's order
  // (finite ascending first): every thread
  int nfin = 0, had = 0, disorder = 0;
  for (int base = 0; base < ef; base += kThreads) {
    const int p = base + tid;
    const float d = p < ef ? bd[p] : 0.f;
    const bool fin = p < ef && d < CUDART_INF_F;
    nfin += __syncthreads_count(fin);
    had += __syncthreads_count(p < ef && bi[p] >= 0);
    disorder += __syncthreads_count(
        fin && p > 0 && !(bd[p - 1] < CUDART_INF_F && bd[p - 1] <= d));
  }
  const float old_last = bd[ef - 1];  // as stored, as the eager step reads it
  const long long stall = stall_io[b];
  if (disorder) {
    rank_beam(s, s.nd, s.ni, s.nx, ef, nfin);
    __syncthreads();
  } else {
    swap_beams(s);  // already in order: the staged beam is the beam
  }

  // pick, then the candidates, the dedup, scoring and ranking (none for a
  // query that is not live), then the merge
  const int npick = pick_and_hash(s, ef, nfin, E, hlog, stall < patience);
  int nc = 0;
  if (npick > 0) {
    enter_candidates(s, nbrs0, npick, C, R0, hlog);
    const int nk = keep_in_order(s, packed, C, R0, D, dedup != 0);
    const float q2 = qn2[b];
    const float thr = nfin == ef ? s.ad[ef - 1] : CUDART_INF_F;
    score_contenders<T, kGroups, kUnits>(
        s, qv, packed, nk, R0, D, vec, lg, thr,
        [&](int r, float dot, float sq) {
          if (pscales != nullptr) {  // int8 blocks: the neighbour's scale
            const int v = s.kl[r];
            const float ps = pscales[(size_t)s.ps[v >> 16] * R0 + (v & 0xffff)];
            dot = __fmul_rn(dot, ps);
            sq = __fmul_rn(__fmul_rn(sq, ps), ps);
          }
          return block_rows::metric_distance(dot, sq, q2, mode);
        });
    nc = s.sc[1];
    rank_contenders(s, nc, ef, R0);
  }
  merge(s, ef, nfin, nc);

  // write back: slot -1 at an infinite distance, unexpanded without a
  // slot; the slots >= 0 and the unexpanded ones counted
  int has = 0, unexpanded = 0;
  for (int base = 0; base < ef; base += kThreads) {
    const int p = base + tid;
    bool slot = false, open = false;
    if (p < ef) {
      const float d = s.nd[p];
      const int i = isinf(d) ? -1 : s.ni[p];
      const int x = s.nx[p] && i >= 0;
      bd[p] = d;
      bi[p] = i;
      bx[p] = (uint8_t)x;
      slot = i >= 0;
      open = slot && !x;
    }
    has += __syncthreads_count(slot);
    unexpanded += __syncthreads_count(open);
  }
  if (tid == 0) {
    const bool improved = s.nd[ef - 1] < old_last || has > had;
    const long long next = npick > 0 ? (improved ? 0 : stall + npick) : stall;
    stall_io[b] = next;
    if (flag != nullptr && unexpanded > 0 && next < patience) atomicOr(flag, 1);
  }
}

template <typename T, bool kQueryShared>
cudaError_t launch(const void* q, const void* qn2, void* beam_d, void* beam_i,
                   void* expanded, void* stall, const void* packed,
                   const void* pscales, const void* nbrs0, void* flag, int B,
                   int D, int R0, int ef, int E, int patience, int mode,
                   int dedup, const Plan& pl, cudaStream_t stream) {
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_step_kernel<T, kQueryShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (err != cudaSuccess) return err;
  }
  // beam_dots.cu's row geometry: the same lanes a row, so the same sums
  int vec, lg;
  block_rows::geometry<T>(packed, D, kUnits, vec, lg);
  beam_step_kernel<T, kQueryShared><<<B, kThreads, pl.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qn2),
      static_cast<float*>(beam_d), static_cast<int*>(beam_i),
      static_cast<uint8_t*>(expanded), static_cast<long long*>(stall),
      static_cast<const T*>(packed), static_cast<const float*>(pscales),
      static_cast<const int*>(nbrs0), static_cast<int*>(flag), D, R0, ef, E,
      patience, mode, dedup, vec, lg, pl.hlog);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_as(const void* q, const void* qn2, void* beam_d,
                      void* beam_i, void* expanded, void* stall,
                      const void* packed, const void* pscales,
                      const void* nbrs0, void* flag, int B, int D, int R0,
                      int ef, int E, int patience, int mode, int dedup,
                      const Plan& pl, cudaStream_t st) {
  return pl.qsm ? launch<T, true>(q, qn2, beam_d, beam_i, expanded, stall, packed,
                                  pscales, nbrs0, flag, B, D, R0, ef, E,
                                  patience, mode, dedup, pl, st)
                : launch<T, false>(q, qn2, beam_d, beam_i, expanded, stall,
                                   packed, pscales, nbrs0, flag, B, D, R0, ef,
                                   E, patience, mode, dedup, pl, st);
}

}  // namespace

extern "C" {

const char* beam_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of one block at (D, ef, E, R0), as the launcher plans it.
long long beam_step_smem_bytes(int D, int ef, int E, int R0) {
  return plan(D, ef, E, R0).bytes;
}

// q [B, D] f32, qn2 [B] f32 (the queries' squared norms), beam_d [B, ef]
// f32, beam_i [B, ef] int32, expanded [B, ef] bool, stall [B] int64 (all
// four read and written in place), packed [cap, R0, D] (dtype 1: bf16,
// 2: int8), pscales [cap, R0] f32 or null (int8 blocks' scales),
// nbrs0 [cap, R0] int32, flag [1] int32 or null (1 OR-ed in where a query
// goes on); E = min(expand, ef) picks a step; mode 0 l2, 1 cosine, 2 inner
// product; all contiguous, on card `device`.
int beam_step(const void* q, const void* qn2, void* beam_d, void* beam_i,
              void* expanded, void* stall, const void* packed,
              const void* pscales, const void* nbrs0, void* flag, int B, int D,
              int R0, int cap, int ef, int E, int patience, int mode, int dedup,
              int dtype, int device, void* stream) {
  // E*R0 within 64 candidates a thread: the dedup's per-thread bit mask
  if (B < 1 || D < 1 || R0 < 1 || cap < 0 || ef < 1 || E < 1 || E > ef ||
      patience < 1 || mode < 0 || mode > 2 || dtype < 1 || dtype > 2 ||
      (long long)E * R0 > 64LL * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(D, ef, E, R0);
  if (pl.bytes > (long long)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    err = launch_as<__nv_bfloat16>(q, qn2, beam_d, beam_i, expanded, stall,
                                   packed, pscales, nbrs0, flag, B, D, R0, ef, E,
                                   patience, mode, dedup, pl, st);
  else
    err = launch_as<int8_t>(q, qn2, beam_d, beam_i, expanded, stall, packed,
                            pscales, nbrs0, flag, B, D, R0, ef, E, patience,
                            mode, dedup, pl, st);
  return static_cast<int>(err);
}

}  // extern "C"
