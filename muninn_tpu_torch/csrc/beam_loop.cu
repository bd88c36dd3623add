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
// latency, hidden by the other blocks of its SM. What the design does about
// it, phase by phase:
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
// Limits: shared memory (4-byte words, `smem_words`): the query (D rounded
// up to 4) where it fits, else it is read from device memory; two beams of
// ef (distance, slot, flag); E*R0 candidates (id, kept (pick, row),
// contender distance and position, sorted distance and id); E pick slots;
// a hash of `h` (key, value) slots, h the power of two at or above
// 2 (ef + E*R0), halved while that does not fit and h / 2 still holds
// ef + E*R0; scratch. ops/beam_loop.py caps ef <= 1024 and E*R0 <= 4096,
// where the block takes at most 192,640 bytes without the query.
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
constexpr int kGroups = 2;           // row groups a warp scores at once
constexpr int kUnits = 4;            // 16-byte loads a lane and row at once
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr int kScratchWords = 32;    // step counters, then per-warp totals
constexpr int kEmpty = -1;           // the key of a free hash slot
constexpr int kNone = 0x7fffffff;    // the value of a free hash slot

// The words of shared memory a block takes (ops/beam_loop.py _smem_bytes
// computes the same): the query dq, the beams, the candidates, the picks,
// the hash, the scratch.
__host__ __device__ constexpr long long smem_words(long long dq, long long ef,
                                                   long long e, long long c,
                                                   long long h) {
  return dq + 6 * ef + 6 * c + e + 2 * h + kScratchWords;
}

struct Plan {
  int hlog;          // log2 of the hash slots
  int qsm;           // the query in shared memory
  long long bytes;   // shared memory of a block
};

// The hash and the query's place for (D, ef, E, R0): see the header.
Plan plan(int D, int ef, int E, int R0) {
  const long long c = (long long)E * R0;
  int hlog = 2;
  while ((1LL << hlog) < 2 * (ef + c)) ++hlog;
  while (smem_words(0, ef, E, c, 1LL << hlog) * 4 > (long long)kMaxSmem &&
         (1LL << (hlog - 1)) >= ef + c)
    --hlog;
  const long long with_q = smem_words(((long long)D + 3) & ~3LL, ef, E, c, 1LL << hlog) * 4;
  if (with_q <= (long long)kMaxSmem) return {hlog, 1, with_q};
  return {hlog, 0, smem_words(0, ef, E, c, 1LL << hlog) * 4};
}

// Enter `id` in the hash with value `val`: its slot keeps the least value
// entered under the id. Returns the slot. The table has more slots than
// ids, so the probe ends.
__device__ __forceinline__ int hash_insert(int* hk, int* hv, int hlog, int id,
                                           int val) {
  const unsigned mask = (1u << hlog) - 1;
  unsigned h = ((unsigned)id * 2654435761u) >> (32 - hlog);
  for (;;) {
    const int k = atomicCAS(&hk[h], kEmpty, id);
    if (k == kEmpty || k == id) {
      atomicMin(&hv[h], val);
      return (int)h;
    }
    h = (h + 1) & mask;
  }
}

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
  float* qs = smem;                                    // [D], padded to 4
  float* ad = qs + (kQueryShared ? (D + 3) & ~3 : 0);  // beam: distance
  int* ai = reinterpret_cast<int*>(ad + ef);           //       slot
  int* ax = ai + ef;                                   //       expanded
  float* nd = reinterpret_cast<float*>(ax + ef);       // next beam
  int* ni = reinterpret_cast<int*>(nd + ef);
  int* nx = ni + ef;
  int* ci = nx + ef;                                   // [C] candidate ids
  int* kl = ci + C;                                    // [C] kept, in order
  float* kd = reinterpret_cast<float*>(kl + C);        // [C] hash slots, then
                                                       //     contenders: distance
  int* kx = reinterpret_cast<int*>(kd + C);            //     and kept position
  float* sd = reinterpret_cast<float*>(kx + C);        // [C] contenders sorted
  int* si = reinterpret_cast<int*>(sd + C);
  int* ps = si + C;                                    // [E] pick slots
  int* hk = ps + E;                                    // [H] hash keys
  int* hv = hk + H;                                    // [H] least values
  int* sc = hv + H;  // [0] picks, [1] contenders, [2] slots in the new beam,
                     // [8, 8 + kWarps) warp totals

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* qv = kQueryShared ? qs : q + b * D;
  if (kQueryShared)
    for (int f = tid; f < D; f += kThreads) qs[f] = q[b * D + f];
  if (max_iters == 0) {  // the loop never runs: the beam as given
    for (int p = tid; p < ef; p += kThreads) {
      out_d[b * ef + p] = init_d[b * ef + p];
      out_i[b * ef + p] = init_i[b * ef + p];
    }
    return;
  }
  const float q2 = qn2[b];
  const int units = vec ? D / 8 : D;
  for (int p = tid; p < ef; p += kThreads) {
    nd[p] = init_d[b * ef + p];
    ni[p] = init_i[b * ef + p];
  }
  for (int s = tid; s < H; s += kThreads) {
    hk[s] = kEmpty;
    hv[s] = kNone;
  }
  int nfin = 0, had = 0;  // finite entries and slots >= 0: every thread
  for (int base = 0; base < ef; base += kThreads) {
    const int p = base + tid;
    nfin += __syncthreads_count(p < ef && init_d[b * ef + p] < CUDART_INF_F);
    had += __syncthreads_count(p < ef && init_i[b * ef + p] >= 0);
  }
  // the initial beam in (distance, position) order, finite entries first;
  // the others follow in position order with their slots, which the first
  // step's dedup still compares against
  for (int p = tid; p < ef; p += kThreads) {
    const float d = nd[p];
    const bool fin = d < CUDART_INF_F;
    int rank = fin ? 0 : nfin;
    for (int o = 0; o < ef; ++o) {
      const float od = nd[o];
      const bool ofin = od < CUDART_INF_F;
      rank += fin ? ofin && (od < d || (od == d && o < p)) : !ofin && o < p;
    }
    ad[rank] = d;
    ai[rank] = ni[p];
    ax[rank] = 0;
  }
  float old_last = init_d[b * ef + ef - 1];  // the first step's, unsorted
  int stall = 0;  // the same in every thread
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // pick: the first E unexpanded entries with a slot, in beam order (warp
    // 0, by ballots), marked expanded; the other warps enter the beam's
    // slots in the hash
    if (warp == 0) {
      int got = 0;
      for (int base = 0; base < nfin && got < E; base += 32) {
        const int p = base + lane;
        const bool f = p < nfin && !ax[p] && ai[p] >= 0;
        const unsigned m = __ballot_sync(0xffffffffu, f);
        const int r = got + __popc(m & ((1u << lane) - 1));
        if (f && r < E) {
          ps[r] = ai[p];
          ax[p] = 1;
        }
        got += __popc(m);
      }
      if (lane == 0) sc[0] = min(got, E);
    } else {
      for (int p = tid - 32; p < ef; p += kThreads - 32)
        if (ai[p] >= 0) hash_insert(hk, hv, hlog, ai[p], -1);
    }
    __syncthreads();
    const int npick = sc[0];
    if (npick == 0 || stall >= patience) break;  // not live: see the header

    // candidates: the picks' neighbour ids, pick-major, entered in the hash
    // (value: the candidate's position); kd holds each one's hash slot
    if (tid == 0) {
      sc[1] = 0;
      sc[2] = 0;
    }
    for (int j = tid; j < C; j += kThreads) {
      const int i = j / R0;
      const int id = i < npick ? nbrs0[(size_t)ps[i] * R0 + (j - i * R0)] : -1;
      ci[j] = id;
      kd[j] = __int_as_float(id >= 0 ? hash_insert(hk, hv, hlog, id, j) : -1);
    }
    __syncthreads();

    // dedup: a candidate is kept where its slot's least value is its own
    // position (not in the beam, no earlier candidate with its id); the
    // kept ones, compacted in order into kl as (pick << 16 | row), thread t
    // holding [t * per, (t + 1) * per), and their rows prefetched into L2
    const int per = (C + kThreads - 1) / kThreads, j0 = tid * per;
    unsigned long long keep = 0;
    for (int t = 0; t < per && j0 + t < C; ++t) {
      const int h = __float_as_int(kd[j0 + t]);
      if (h >= 0 && hv[h] == j0 + t) keep |= 1ull << t;
    }
    const int cnt = __popcll(keep);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) sc[8 + warp] = incl;
    __syncthreads();
    int at = incl - cnt, nk = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int tw = sc[8 + w];
      at += w < warp ? tw : 0;
      nk += tw;
    }
    for (int t = 0; t < per; ++t) {
      if (!(keep >> t & 1)) continue;
      const int j = j0 + t, i = j / R0;
      kl[at++] = i << 16 | (j - i * R0);
      const char* row = reinterpret_cast<const char*>(
          packed + ((size_t)ps[i] * R0 + (j - i * R0)) * D);
      for (int off = 0; off < D * 2; off += 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(row + off));
    }
    __syncthreads();

    // score: the kept rows (block_rows.cuh); the hash is cleared meanwhile.
    // A kept candidate contends for the next beam where its distance is
    // below `thr`, the last entry of a full beam (beam first on equal
    // distances: no other can place); contenders go to (kd, kx) as
    // (distance, kept position), in any order
    for (int s = tid; s < H; s += kThreads) {
      hk[s] = kEmpty;
      hv[s] = kNone;
    }
    const float thr = nfin == ef ? ad[ef - 1] : CUDART_INF_F;
    block_rows::score_rows<__nv_bfloat16, kGroups, kUnits>(
        qv, nk, units, lg, vec, warp, kWarps, lane,
        [&](int s) -> const __nv_bfloat16* {
          const int v = kl[s];
          return packed + ((size_t)ps[v >> 16] * R0 + (v & 0xffff)) * D;
        },
        [&](int s, float dot, float sq, bool) {
          const float d = block_rows::metric_distance(dot, sq, q2, mode);
          if (d < thr) {
            const int at = atomicAdd(&sc[1], 1);
            kd[at] = d;
            kx[at] = s;
          }
        });
    __syncthreads();

    // rank: the contenders in (distance, kept position) order, each ranked
    // among the others, four at a time; the count stops once it reaches
    // ef, since a contender with ef better ones cannot place
    const int nc = sc[1];
    for (int a = tid; a < nc; a += kThreads) {
      const float d = kd[a];
      const int x = kx[a];
      int rank = 0;
      for (int o = 0; o < nc && rank < ef; o += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (o + u >= nc) break;
          const float od = kd[o + u];
          rank += od < d || (od == d && kx[o + u] < x);
        }
      }
      if (rank < ef) {
        const int v = kl[x];
        sd[rank] = d;
        si[rank] = ci[(v >> 16) * R0 + (v & 0xffff)];
      }
    }
    __syncthreads();

    // merge: the sorted beam and the sorted run into the next beam, the
    // beam first on equal distances; each entry's place is its own index
    // plus the other run's entries before it
    const int nkf = min(nc, ef), nn = min(ef, nfin + nc);  // sd holds nkf
    int mine = 0;
    for (int p = tid; p < nfin; p += kThreads) {
      const float d = ad[p];
      int lo = 0, hi = nkf;  // run entries below d
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (sd[m] < d) lo = m + 1; else hi = m;
      }
      if (p + lo < ef) {
        nd[p + lo] = d;
        ni[p + lo] = ai[p];
        nx[p + lo] = ax[p];
        mine += ai[p] >= 0;
      }
    }
    for (int s = tid; s < nkf; s += kThreads) {
      const float d = sd[s];
      int lo = 0, hi = nfin;  // beam entries at or below d
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (ad[m] <= d) lo = m + 1; else hi = m;
      }
      if (s + lo < ef) {
        nd[s + lo] = d;
        ni[s + lo] = si[s];
        nx[s + lo] = 0;
        ++mine;
      }
    }
    for (int p = nn + tid; p < ef; p += kThreads) {
      nd[p] = CUDART_INF_F;
      ni[p] = -1;
      nx[p] = 0;
    }
    mine = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0 && mine) atomicAdd(&sc[2], mine);
    __syncthreads();

    // patience: fill-aware improvement, counted in expansions
    const int has = sc[2];
    stall = (nd[ef - 1] < old_last || has > had) ? 0 : stall + npick;
    had = has;
    nfin = nn;
    old_last = nd[ef - 1];
    float* tf = ad; ad = nd; nd = tf;
    int* ti = ai; ai = ni; ni = ti;
    ti = ax; ax = nx; nx = ti;
  }
  for (int p = tid; p < ef; p += kThreads) {
    out_d[b * ef + p] = p < nfin ? ad[p] : CUDART_INF_F;
    out_i[b * ef + p] = p < nfin ? ai[p] : -1;
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
