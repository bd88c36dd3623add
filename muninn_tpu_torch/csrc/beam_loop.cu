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
// The beam is kept sorted by (distance, position), finite entries first: the
// initial beam is ranked once, and every merge writes its result in order.
// So the picks are the first E unexpanded entries with a slot (one warp,
// ballots), and the merge is one of two sorted runs, beam first on equal
// distances (a binary search per entry). The first step's patience test
// reads the caller's unsorted beam, as the reference does.
//
// Early exit: a query that is not live at a step never changes again (no
// candidates, stall frozen, and its beam is already the sorted result of a
// merge), so its block stops there; the result equals running all max_iters
// steps, as the TPU kernel does.
//
// What bounds it on an H100: on paper device-memory bytes, the neighbour ids
// (E*R0*4 B per step) and the fresh candidates' rows (D*2 B each; a dropped
// candidate's row is never read). In practice a step is a chain of
// block-wide phases separated by barriers and two dependent round trips to
// device memory (the picks' ids, then the kept rows), so a block's time is
// latency, hidden by the other blocks of its SM. The phases live in
// csrc/beam_phases.cuh, which csrc/beam_step.cu shares; what they do about
// it:
//   - dedup in O(1) a candidate: a shared-memory hash of the beam's and the
//     candidates' ids (linear probing, at most half full where shared memory
//     allows), whose slot keeps the lowest candidate holding the id (atomicMin;
//     -1 for a beam slot): a candidate is kept where it is that lowest one;
//   - the kept candidates compacted in order (a per-thread bit mask, warp
//     scan, one barrier), so scoring is dense and the sort ranks only them;
//   - the kept rows prefetched into L2 as soon as they are known, then
//     scored through block_rows.cuh, many rows a warp in flight;
//   - only contenders sorted: once the beam is full, a candidate at or
//     above its last distance cannot place (the beam goes first on equal
//     distances), so only those below it are ranked, by counting among
//     themselves up to ef, then merged with the beam by binary searches:
//     O((ef + contenders) log) instead of counting over ef + E*R0.
// Blocks of 128 threads: a step's phases are short, and more, smaller
// blocks an SM overlap one block's scoring with another's bookkeeping
// better than fewer blocks of 256 (tools/probes/beam_probe.py).
//
// Limits: shared memory, as beam_phases.cuh lays it out and plans it
// (`smem_words`, `plan`): ops/beam_loop.py caps ef <= 1024 and
// E*R0 <= 4096, where the block takes at most 192,640 bytes without the
// query.
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

constexpr int kGroups = 2;           // row groups a warp scores at once
constexpr int kUnits = 4;            // 16-byte loads a lane and row at once

template <bool kQueryShared>
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
                 int mode, int vec, int lg, int hlog) {
  extern __shared__ __align__(16) float smem[];
  const int C = E * R0, H = 1 << hlog;
  Smem s = carve(smem, kQueryShared ? (D + 3) & ~3 : 0, ef, C, E, H);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* qv = kQueryShared ? s.qs : q + b * D;
  if (kQueryShared)
    for (int f = tid; f < D; f += kThreads) s.qs[f] = q[b * D + f];
  if (max_iters == 0) {  // the loop never runs: the beam as given
    for (int p = tid; p < ef; p += kThreads) {
      out_d[b * ef + p] = init_d[b * ef + p];
      out_i[b * ef + p] = init_i[b * ef + p];
    }
    return;
  }
  const float q2 = qn2[b];
  for (int p = tid; p < ef; p += kThreads) {
    s.nd[p] = init_d[b * ef + p];
    s.ni[p] = init_i[b * ef + p];
  }
  clear_hash(s, H);
  int nfin = 0, had = 0;  // finite entries and slots >= 0: every thread
  for (int base = 0; base < ef; base += kThreads) {
    const int p = base + tid;
    nfin += __syncthreads_count(p < ef && init_d[b * ef + p] < CUDART_INF_F);
    had += __syncthreads_count(p < ef && init_i[b * ef + p] >= 0);
  }
  // the initial beam in (distance, position) order, finite entries first
  rank_beam(s, s.nd, s.ni, nullptr, ef, nfin);
  float old_last = init_d[b * ef + ef - 1];  // the first step's, unsorted
  int stall = 0;  // the same in every thread
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // pick: the first E unexpanded entries with a slot; a query that is not
    // live picks none and stops here (see the header)
    const int npick = pick_and_hash(s, ef, nfin, E, hlog, stall < patience);
    if (npick == 0) break;
    // candidates: the picks' neighbour ids, entered in the hash
    enter_candidates(s, nbrs0, npick, C, R0, hlog);
    // dedup: the kept candidates in order, their rows prefetched
    const int nk = keep_in_order(s, packed, C, R0, D, true);
    // score: the kept rows; the hash is cleared meanwhile
    clear_hash(s, H);
    const float thr = nfin == ef ? s.ad[ef - 1] : CUDART_INF_F;
    score_contenders<__nv_bfloat16, kGroups, kUnits>(
        s, qv, packed, nk, R0, D, vec, lg, thr,
        [&](int, float dot, float sq) {
          return block_rows::metric_distance(dot, sq, q2, mode);
        });
    // rank: the contenders in (distance, kept position) order
    const int nc = s.sc[1];
    rank_contenders(s, nc, ef, R0);
    // merge: the sorted beam and the sorted run into the next beam
    const int nn = merge(s, ef, nfin, nc);

    // patience: fill-aware improvement, counted in expansions
    const int has = s.sc[2];
    stall = (s.nd[ef - 1] < old_last || has > had) ? 0 : stall + npick;
    had = has;
    nfin = nn;
    old_last = s.nd[ef - 1];
    swap_beams(s);
  }
  for (int p = tid; p < ef; p += kThreads) {
    out_d[b * ef + p] = p < nfin ? s.ad[p] : CUDART_INF_F;
    out_i[b * ef + p] = p < nfin ? s.ai[p] : -1;
  }
}

template <bool kQueryShared>
cudaError_t launch(const void* q, const void* qn2, const void* init_d,
                   const void* init_i, const void* packed, const void* nbrs0,
                   void* out_d, void* out_i, int B, int D, int R0, int ef,
                   int E, int patience, int max_iters, int mode, const Plan& pl,
                   cudaStream_t stream) {
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_loop_kernel<kQueryShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (err != cudaSuccess) return err;
  }
  const int vec = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && D % 8 == 0;
  beam_loop_kernel<kQueryShared><<<B, kThreads, pl.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(qn2),
      static_cast<const float*>(init_d), static_cast<const int*>(init_i),
      static_cast<const __nv_bfloat16*>(packed),
      static_cast<const int*>(nbrs0), static_cast<float*>(out_d),
      static_cast<int*>(out_i), D, R0, ef, E, patience, max_iters, mode, vec,
      block_rows::lanes_log2(vec ? D / 8 : D, kUnits), pl.hlog);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* beam_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of one block at (D, ef, E, R0), as the launcher plans it.
long long beam_loop_smem_bytes(int D, int ef, int E, int R0) {
  return plan(D, ef, E, R0).bytes;
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
  // E*R0 within 64 candidates a thread: the dedup's per-thread bit mask
  if (B < 1 || D < 1 || R0 < 1 || cap < 0 || ef < 1 || E < 1 || E > ef ||
      patience < 1 || max_iters < 0 || mode < 0 || mode > 2 ||
      (long long)E * R0 > 64LL * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(D, ef, E, R0);
  if (pl.bytes > (long long)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = pl.qsm ? launch<true>(q, qn2, init_d, init_i, packed, nbrs0, out_d, out_i,
                              B, D, R0, ef, E, patience, max_iters, mode, pl, st)
               : launch<false>(q, qn2, init_d, init_i, packed, nbrs0, out_d, out_i,
                               B, D, R0, ef, E, patience, max_iters, mode, pl, st);
  return static_cast<int>(err);
}

}  // extern "C"
