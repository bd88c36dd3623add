// The phases of one step of the HNSW level-0 beam, shared by the kernels
// that run it: csrc/beam_loop.cu (every step of a query in one block, the
// beam in shared memory throughout) and csrc/beam_step.cu (one step a
// launch, the beam read from and written back to device memory). A phase
// is run by every thread of a 128-thread block and ends on a barrier where
// the next one reads what it wrote.
//
// A step, over one query's beam (distance, slot, expanded flag) of ef
// entries, sorted by (distance, position), finite entries first:
//   pick_and_hash      the first E unexpanded entries with a slot, marked
//                      expanded (warp 0, ballots); the other warps enter
//                      the beam's slots in the hash;
//   enter_candidates   the picks' neighbour ids, pick-major, entered in the
//                      hash under their positions;
//   keep_in_order      a candidate is kept where its id is not in the beam
//                      and (with dedup) no earlier candidate holds it: the
//                      hash slot keeps the least value entered under an id
//                      (atomicMin; -1 for a beam slot); the kept ones
//                      compacted in order (per-thread bit masks, a warp
//                      scan) and their rows prefetched into L2;
//   score_contenders   the kept rows through block_rows.cuh; a kept
//                      candidate contends where its distance is below
//                      `thr` (the last entry of a full beam, which goes
//                      first on equal distances);
//   rank_contenders    the contenders in (distance, kept position) order,
//                      each counted among the others up to ef;
//   merge              the sorted beam and the sorted run into the next
//                      beam by binary searches, the beam first on equal
//                      distances, (inf, -1, unexpanded) past the finite
//                      entries; the slots >= 0 of the new beam counted.
// rank_beam puts a caller's unsorted beam in that order first.
//
// Shared memory (4-byte words, `smem_words`): the query (D rounded up to
// 4) where it fits, else it is read from device memory; two beams of ef
// (distance, slot, flag); E*R0 candidates (id, kept (pick, row), contender
// distance and position, sorted distance and id); E pick slots; a hash of
// `h` (key, value) slots, h the power of two at or above 2 (ef + E*R0),
// halved while that does not fit and h / 2 still holds ef + E*R0;
// scratch. ops/beam_loop.py caps ef <= 1024 and E*R0 <= 4096, where a
// block takes at most 192,640 bytes without the query.
//
// `_build.py` hashes this header with each source, so a change here
// rebuilds both kernels.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_rows.cuh"

namespace beam_phases {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr int kScratchWords = 32;    // step counters, then per-warp totals
constexpr int kEmpty = -1;           // the key of a free hash slot
constexpr int kNone = 0x7fffffff;    // the value of a free hash slot

// The words of shared memory a block takes (ops/beam_loop.py _smem_words
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
inline Plan plan(int D, int ef, int E, int R0) {
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

// One block's shared memory, laid out as smem_words counts it.
struct Smem {
  float* qs;  // [D], padded to 4, where the query is shared
  float* ad;  // beam: distance
  int* ai;    //       slot
  int* ax;    //       expanded
  float* nd;  // next beam
  int* ni;
  int* nx;
  int* ci;    // [C] candidate ids
  int* kl;    // [C] kept, in order, as (pick << 16 | row)
  float* kd;  // [C] hash slots, then contenders: distance
  int* kx;    //     and kept position
  float* sd;  // [C] contenders sorted
  int* si;
  int* ps;    // [E] pick slots
  int* hk;    // [H] hash keys
  int* hv;    // [H] least values
  int* sc;    // [0] picks, [1] contenders, [2] slots in the new beam,
              // [8, 8 + kWarps) warp totals
};

__device__ __forceinline__ Smem carve(float* smem, int dq, int ef, int C, int E,
                                      int H) {
  Smem s;
  s.qs = smem;
  s.ad = s.qs + dq;
  s.ai = reinterpret_cast<int*>(s.ad + ef);
  s.ax = s.ai + ef;
  s.nd = reinterpret_cast<float*>(s.ax + ef);
  s.ni = reinterpret_cast<int*>(s.nd + ef);
  s.nx = s.ni + ef;
  s.ci = s.nx + ef;
  s.kl = s.ci + C;
  s.kd = reinterpret_cast<float*>(s.kl + C);
  s.kx = reinterpret_cast<int*>(s.kd + C);
  s.sd = reinterpret_cast<float*>(s.kx + C);
  s.si = reinterpret_cast<int*>(s.sd + C);
  s.ps = s.si + C;
  s.hk = s.ps + E;
  s.hv = s.hk + H;
  s.sc = s.hv + H;
  return s;
}

// Swap the beam and the next beam.
__device__ __forceinline__ void swap_beams(Smem& s) {
  float* tf = s.ad; s.ad = s.nd; s.nd = tf;
  int* ti = s.ai; s.ai = s.ni; s.ni = ti;
  ti = s.ax; s.ax = s.nx; s.nx = ti;
}

__device__ __forceinline__ void clear_hash(const Smem& s, int H) {
  for (int h = threadIdx.x; h < H; h += kThreads) {
    s.hk[h] = kEmpty;
    s.hv[h] = kNone;
  }
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

// The beam (src_d, src_i, src_x; src_x null: unexpanded) into (ad, ai, ax)
// in (distance, position) order, finite entries first (`nfin` of them);
// the others follow in position order with their slots, which the step's
// dedup still compares against. No barrier.
__device__ __forceinline__ void rank_beam(const Smem& s, const float* src_d,
                                          const int* src_i, const int* src_x,
                                          int ef, int nfin) {
  for (int p = threadIdx.x; p < ef; p += kThreads) {
    const float d = src_d[p];
    const bool fin = d < CUDART_INF_F;
    int rank = fin ? 0 : nfin;
    for (int o = 0; o < ef; ++o) {
      const float od = src_d[o];
      const bool ofin = od < CUDART_INF_F;
      rank += fin ? ofin && (od < d || (od == d && o < p)) : !ofin && o < p;
    }
    s.ad[rank] = d;
    s.ai[rank] = src_i[p];
    s.ax[rank] = src_x == nullptr ? 0 : src_x[p];
  }
}

// pick: where `allow`, the first E unexpanded entries with a slot, in beam
// order (warp 0, by ballots), marked expanded, their slots in ps; the other
// warps enter the beam's slots in the hash. Returns the picks.
__device__ __forceinline__ int pick_and_hash(const Smem& s, int ef, int nfin,
                                             int E, int hlog, bool allow) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    int got = 0;
    for (int base = 0; allow && base < nfin && got < E; base += 32) {
      const int p = base + lane;
      const bool f = p < nfin && !s.ax[p] && s.ai[p] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int r = got + __popc(m & ((1u << lane) - 1));
      if (f && r < E) {
        s.ps[r] = s.ai[p];
        s.ax[p] = 1;
      }
      got += __popc(m);
    }
    if (lane == 0) s.sc[0] = min(got, E);
  } else {
    for (int p = tid - 32; p < ef; p += kThreads - 32)
      if (s.ai[p] >= 0) hash_insert(s.hk, s.hv, hlog, s.ai[p], -1);
  }
  __syncthreads();
  return s.sc[0];
}

// candidates: the picks' neighbour ids, pick-major, entered in the hash
// (value: the candidate's position); kd holds each one's hash slot.
__device__ __forceinline__ void enter_candidates(const Smem& s,
                                                 const int* __restrict__ nbrs0,
                                                 int npick, int C, int R0,
                                                 int hlog) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    s.sc[1] = 0;
    s.sc[2] = 0;
  }
  for (int j = tid; j < C; j += kThreads) {
    const int i = j / R0;
    const int id = i < npick ? nbrs0[(size_t)s.ps[i] * R0 + (j - i * R0)] : -1;
    s.ci[j] = id;
    s.kd[j] = __int_as_float(id >= 0 ? hash_insert(s.hk, s.hv, hlog, id, j) : -1);
  }
  __syncthreads();
}

// dedup: a candidate is kept where its id is not in the beam and, with
// `dedup`, its slot's least value is its own position (no earlier
// candidate with its id); the kept ones, compacted in order into kl as
// (pick << 16 | row), thread t holding [t * per, (t + 1) * per), and their
// rows prefetched into L2. Returns the kept count.
template <typename T>
__device__ __forceinline__ int keep_in_order(const Smem& s,
                                             const T* __restrict__ packed,
                                             int C, int R0, int D, bool dedup) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (C + kThreads - 1) / kThreads, j0 = tid * per;
  unsigned long long keep = 0;
  for (int t = 0; t < per && j0 + t < C; ++t) {
    const int h = __float_as_int(s.kd[j0 + t]);
    if (h >= 0 && (dedup ? s.hv[h] == j0 + t : s.hv[h] >= 0)) keep |= 1ull << t;
  }
  const int cnt = __popcll(keep);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s.sc[8 + warp] = incl;
  __syncthreads();
  int at = incl - cnt, nk = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int tw = s.sc[8 + w];
    at += w < warp ? tw : 0;
    nk += tw;
  }
  for (int t = 0; t < per; ++t) {
    if (!(keep >> t & 1)) continue;
    const int j = j0 + t, i = j / R0;
    s.kl[at++] = i << 16 | (j - i * R0);
    const char* row = reinterpret_cast<const char*>(
        packed + ((size_t)s.ps[i] * R0 + (j - i * R0)) * D);
    for (int off = 0; off < D * (int)sizeof(T); off += 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + off));
  }
  __syncthreads();
  return nk;
}

// score: the nk kept rows through block_rows.cuh (kGroups row groups a
// warp, kUnits loads a lane and row in a pass; `vec` and `lg` as the
// launcher chose them); `dist_of(s, dot, sq)` turns kept row s's dot and
// squared norm into its distance. A row contends where that is below `thr`:
// (kd, kx) get (distance, kept position), in any order; sc[1] counts them.
template <typename T, int kGroups, int kUnits, typename DistOf>
__device__ __forceinline__ void score_contenders(const Smem& s, const float* qv,
                                                 const T* __restrict__ packed,
                                                 int nk, int R0, int D, int vec,
                                                 int lg, float thr,
                                                 DistOf dist_of) {
  const int tid = threadIdx.x;
  const int units = vec ? D / (16 / (int)sizeof(T)) : D;
  block_rows::score_rows<T, kGroups, kUnits>(
      qv, nk, units, lg, vec, tid >> 5, kWarps, tid & 31,
      [&](int r) -> const T* {
        const int v = s.kl[r];
        return packed + ((size_t)s.ps[v >> 16] * R0 + (v & 0xffff)) * D;
      },
      [&](int r, float dot, float sq, bool) {
        const float d = dist_of(r, dot, sq);
        if (d < thr) {
          const int at = atomicAdd(&s.sc[1], 1);
          s.kd[at] = d;
          s.kx[at] = r;
        }
      });
  __syncthreads();
}

// rank: the nc contenders in (distance, kept position) order into (sd, si),
// each ranked among the others, four at a time; the count stops once it
// reaches ef, since a contender with ef better ones cannot place.
__device__ __forceinline__ void rank_contenders(const Smem& s, int nc, int ef,
                                                int R0) {
  for (int a = threadIdx.x; a < nc; a += kThreads) {
    const float d = s.kd[a];
    const int x = s.kx[a];
    int rank = 0;
    for (int o = 0; o < nc && rank < ef; o += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (o + u >= nc) break;
        const float od = s.kd[o + u];
        rank += od < d || (od == d && s.kx[o + u] < x);
      }
    }
    if (rank < ef) {
      const int v = s.kl[x];
      s.sd[rank] = d;
      s.si[rank] = s.ci[(v >> 16) * R0 + (v & 0xffff)];
    }
  }
  __syncthreads();
}

// merge: the sorted beam's nfin finite entries and the sorted run of nc
// contenders into (nd, ni, nx), the beam first on equal distances; each
// entry's place is its own index plus the other run's entries before it;
// (inf, -1, 0) past them. sc[2] counts the new beam's slots >= 0. Returns
// its finite entries.
__device__ __forceinline__ int merge(const Smem& s, int ef, int nfin, int nc) {
  const int tid = threadIdx.x;
  const int nkf = min(nc, ef), nn = min(ef, nfin + nc);  // sd holds nkf
  int mine = 0;
  for (int p = tid; p < nfin; p += kThreads) {
    const float d = s.ad[p];
    int lo = 0, hi = nkf;  // run entries below d
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (s.sd[m] < d) lo = m + 1; else hi = m;
    }
    if (p + lo < ef) {
      s.nd[p + lo] = d;
      s.ni[p + lo] = s.ai[p];
      s.nx[p + lo] = s.ax[p];
      mine += s.ai[p] >= 0;
    }
  }
  for (int r = tid; r < nkf; r += kThreads) {
    const float d = s.sd[r];
    int lo = 0, hi = nfin;  // beam entries at or below d
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (s.ad[m] <= d) lo = m + 1; else hi = m;
    }
    if (r + lo < ef) {
      s.nd[r + lo] = d;
      s.ni[r + lo] = s.si[r];
      s.nx[r + lo] = 0;
      ++mine;
    }
  }
  for (int p = nn + tid; p < ef; p += kThreads) {
    s.nd[p] = CUDART_INF_F;
    s.ni[p] = -1;
    s.nx[p] = 0;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((tid & 31) == 0 && mine) atomicAdd(&s.sc[2], mine);
  __syncthreads();
  return nn;
}

}  // namespace beam_phases
