// The repair of an HNSW delete wave in one launch: every live row that
// pointed at a deleted slot gets exact f32 distances to the wave's repair
// pool, keeps its kk closest pool rows beside the accumulators, merges them
// with its surviving edges and writes the closest M back in place.
//
// Replaces: no TPU kernel of its own. muninn_tpu/index/hnsw.py
// `_delete_repair_rows` (:1860-1896) is XLA glue around `flat_topk` at
// precision="highest" (ops/pallas_flat.py `_flat_topk_kernel`, float
// branch); the port ran it as chunks of 4,096 affected rows, each one
// launch of csrc/flat_topk.cu with corpus splits, a torch.topk merge of
// the splits and some 190 eager ops (gathers, masks, three stable sorts,
// scatters), fed by two host reads of the affected rows and the pool.
// This kernel is that whole chain for every affected row of a wave.
//
// Inputs, all on the card and listed there by index/hnsw.py
// `_delete_lists` without a host read: the affected slots `aff` and the
// pool slots `pool`, each ascending and -1 after its last entry, their two
// counts in device memory (`counts`), the pool's rows gathered once
// (`c`) with their penalty row and cosine scales, the deleted-slot mask.
// Blocks past the affected count return at once, so the host launches a
// grid for the list's bound and never reads the count.
//
// Distances: bit for bit those of flat_topk's `highest` mode (the same
// staged f32 FMA chain in feature order, the same epilogue form):
//   mode 0, l2:            (qn - 2*dot) + cp
//   mode 1, cosine:        (1 - dot*cs) + cp   rows unit-normalised by the
//                          caller, cs[n] = 1/|c_n|
//   mode 2, inner product: cp - dot
// Then per row, as index/hnsw.py `_repair_rows` computes it in eager
// torch: the candidates' pool positions become slots and the row's own
// slot is masked; the row's edges to deleted slots become (+inf, -1); the
// M edges and kk candidates are merged as ops/topk.py `merge_topk` merges
// them (each id once at its closest distance, then ascending by (distance,
// id)) and the first M are written over the row.
//
// What bounds it on an H100: the f32 FMAs on CUDA cores (67 TFLOP/s peak,
// data sheet, 700 W): a wave of 59k affected rows against a pool of 50k at
// d = 384 is 2.3 TFLOP, 34 ms. What the design does about it:
//   - csrc/flat_topk.cu's main loop, carried over: a block of 256 threads
//     holds a tile of TQ affected rows and walks the pool in tiles of 256
//     rows, stages of 32 features in a cp.async ring, register-blocked
//     FMAs, the top-kk beside the accumulators (csrc/topk_merge.cuh). The
//     affected rows are loaded by slot from the table in the load stage,
//     so they are never gathered in device memory.
//   - TQ = 128 at kk 33, as the exact scans run flat_topk at k 10: each
//     pool element staged feeds 256 flops, so the staging traffic is half
//     what flat_topk's own plan for k 33 (TQ = 64) asks. Its ring of 3
//     stages fits beside the [128, 64] top-kk buffers because the tile's
//     penalty and cosine scale are read from global memory, not staged.
//   - No corpus splits: the affected rows alone give some 400-500 tiles, 3-4
//     waves of the card's 132 SMs, so there are no split partials and no
//     merge of them. Blocks are scheduled in index order and all walk the
//     pool from its start, so the blocks resident at once read the same
//     pool tiles at about the same time and the 77 MB pool is served from
//     the 50 MB L2 for the most part.
//   - The merge with the survivors runs once per row after the main loop,
//     in the ring's shared memory (one warp a row, two bitonic sorts of at
//     most 128 entries), far below the FMA time.
//
// The tiling (TQ, W, stages) is chosen in Python (ops/delete_repair.py
// `repair_plan`), which checks its shared-memory count against
// `delete_repair_smem_bytes` when the library loads; the merge scratch
// lives in the ring.
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
constexpr int kTileRows = 256;            // pool rows per tile
constexpr int kDepth = 32;                // features per stage
constexpr int kStride = kDepth + 4;       // words per staged row
constexpr int kMaxK = 64;                 // largest kk (M + 1 with M <= 63)
constexpr int kMerge = 128;               // a row's merge scratch, >= M + kk
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block may use

struct Plan {
  int tq, w, stages;
};

// A warp owns TQ / 8 affected rows; its lanes form kLy lane rows of kLx
// lane columns. A thread holds kRq rows (ly + kLy * i) by kRc pool rows of
// the tile (lx + kLx * j).
template <int TQ>
struct Geometry {
  static constexpr int kRowsPerWarp = TQ / kWarps;
  static constexpr int kLy = kRowsPerWarp >= 2 ? 2 : 1;
  static constexpr int kLx = 32 / kLy;
  static constexpr int kRq = kRowsPerWarp / kLy;
  static constexpr int kRc = kTileRows / kLx;
  static_assert(kRq * kLy == kRowsPerWarp && kRc * kLx == kTileRows, "tiling");
};

__host__ __device__ constexpr int check_cols(int tq) {
  return tq / kWarps >= 2 ? 16 : 32;
}

// Shared memory, in 4-byte words from the base, as csrc/flat_topk.cu lays
// it out but for the penalty and cosine scale, which the selection reads
// from global memory (the same 256 values for every thread of a block, so
// from L1), so that a tile of 128 rows keeps a ring of 3 stages at kk 33:
//   stage s [stages]: rows [TQ][kStride], pool [kTileRows][kStride]
//   bd [TQ][W] f32, bi [TQ][W] int32: per row, top-kk in [0, kk),
//   candidates after; cnt [TQ] candidates waiting; thr [TQ] threshold
// After the main loop the ring holds each warp's merge scratch,
// [kWarps][2][kMerge] words.
__host__ __device__ constexpr int stage_words(int tq) {
  return (tq + kTileRows) * kStride;
}
__host__ __device__ constexpr size_t smem_bytes(Plan p) {
  return 4ull * p.stages * stage_words(p.tq) + 8ull * p.tq * p.w + 8ull * p.tq;
}
static_assert(kMinStages * stage_words(8) >= kWarps * 2 * kMerge,
              "the merge scratch fits in the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Start the copies of one stage: features d0..d0+31 of the tile's affected
// rows (row r is table row aff[q0 + r], zero from r = live on) and of pool
// rows t0..t0+255 (zero from row_hi on), zero past D. vec: 16-byte copies,
// 8 lanes to a row; else 4-byte copies, a warp to a row.
template <int TQ>
__device__ __forceinline__ void load_stage(uint32_t st, const float* v,
                                           const long long* aff, const float* c,
                                           int q0, int live, int t0, int row_hi,
                                           int d0, int D, bool vec, int tid) {
  constexpr int kRows = TQ + kTileRows;
  if (vec) {
    const int u = tid & 7, f = d0 + 4 * u;
#pragma unroll
    for (int w = 0; w < (kRows + 31) / 32; ++w) {
      const int r = (tid >> 3) + 32 * w;
      if (r >= kRows) break;
      const bool row = r < TQ;
      const bool in = (row ? r < live : t0 + r - TQ < row_hi) && f < D;
      const float* src =
          !in ? c
              : (row ? v + (size_t)__ldg(aff + q0 + r) * D
                     : c + (size_t)(t0 + r - TQ) * D) + f;
      cp16(st + 4 * (r * kStride + 4 * u), src, in ? 16 : 0);
    }
  } else {
    const int u = tid & 31, f = d0 + u;
    for (int r = tid >> 5; r < kRows; r += kWarps) {
      const bool row = r < TQ;
      const bool in = (row ? r < live : t0 + r - TQ < row_hi) && f < D;
      const float* src =
          !in ? c
              : (row ? v + (size_t)__ldg(aff + q0 + r) * D
                     : c + (size_t)(t0 + r - TQ) * D) + f;
      cp4(st + 4 * (r * kStride + u), src, in ? 4 : 0);
    }
  }
}

// One stage's products: acc[i][j] += <affected row, pool row> over the
// stage's 32 features, 4 at a time, in feature order (csrc/flat_topk.cu's
// `multiply`, the same FMA chain).
template <int TQ>
__device__ __forceinline__ void multiply(
    const float* st, int qrow, int lx,
    float (&acc)[Geometry<TQ>::kRq][Geometry<TQ>::kRc]) {
  using G = Geometry<TQ>;
  const float* qs = st + qrow * kStride;
  const float* cs = st + (TQ + lx) * kStride;
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

// One warp's part of a tile's selection, csrc/flat_topk.cu's `select_tile`
// with the tile's penalty cp and cosine scale cs read from global memory:
// the accumulators become distances d = fma(dot, sc, rt) + cp in place; a
// tile where no value beats its row's threshold ends at one vote; else the
// passing values of each column with a pass are appended at ballot
// positions, after a merge of each row whose region would overflow.
template <int TQ>
__device__ __forceinline__ void select_tile(
    float (&acc)[Geometry<TQ>::kRq][Geometry<TQ>::kRc],
    const float (&rt)[Geometry<TQ>::kRq], const float* __restrict__ cp,
    const float* __restrict__ cs, float* bd, int* bi, int* cnt, float* thr,
    int k, int W, int mode, int t0, int row_hi, int qrow, int live, int ly,
    int lx, int lane) {
  using G = Geometry<TQ>;
  constexpr unsigned kAll = 0xffffffffu;
  const int cap = W - k;
  const int row0 = qrow - ly;
  float t[G::kRq];
#pragma unroll
  for (int i = 0; i < G::kRq; ++i)
    t[i] = qrow + i * G::kLy < live ? thr[qrow + i * G::kLy] : -CUDART_INF_F;
  unsigned cols = 0;
#pragma unroll
  for (int j = 0; j < G::kRc; ++j) {
    const int col = t0 + lx + j * G::kLx;
    const bool in = col < row_hi;
    const float cpj = in ? __ldg(cp + col) : CUDART_INF_F;
    const float scj =
        mode == 0 ? -2.f : mode == 2 ? -1.f : in ? -__ldg(cs + col) : 0.f;
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      const float d = fmaf(acc[i][j], scj, rt[i]) + cpj;
      acc[i][j] = d;
      if (d < t[i]) cols |= 1u << j;
    }
  }
  cols = __reduce_or_sync(kAll, cols);
  if (cols == 0) return;
  const unsigned mine = G::kLy == 2 ? (ly ? 0xffff0000u : 0x0000ffffu) : kAll;
  const unsigned below = mine & ((1u << lane) - 1u);
  for (; cols != 0; cols &= cols - 1) {
    const int j = __ffs(cols) - 1;
    float v[G::kRq];
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) {
      v[i] = acc[i][0];
#pragma unroll
      for (int jj = 1; jj < G::kRc; ++jj) v[i] = j == jj ? acc[i][jj] : v[i];
    }
    unsigned bal[G::kRq];
#pragma unroll
    for (int i = 0; i < G::kRq; ++i) bal[i] = __ballot_sync(kAll, v[i] < t[i]);
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
      __syncwarp();
      if (lx == 0) cnt[r] = c0 + __popc(bal[i] & mine);
      __syncwarp();
    }
  }
}

// (id, distance) order, for the dedup of a row's merge.
__device__ __forceinline__ bool id_before(float da, int ia, float db, int ib) {
  return ia < ib || (ia == ib && da < db);
}

// One warp sorts p (a power of two, at most kMerge) entries of shared
// memory ascending: by (id, distance) with ByID, else by (distance, id).
template <bool ByID>
__device__ void warp_sort(float* d, int* id, int p, int lane) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const float dl = d[lo], dh = d[hi];
        const int il = id[lo], ih = id[hi];
        const bool up = (lo & size) == 0;
        const bool swap = ByID ? (up ? id_before(dh, ih, dl, il)
                                     : id_before(dl, il, dh, ih))
                               : (up ? before(dh, ih, dl, il)
                                     : before(dl, il, dh, ih));
        if (swap) {
          d[lo] = dh; d[hi] = dl;
          id[lo] = ih; id[hi] = il;
        }
      }
      __syncwarp();
    }
  }
}

// One affected row's epilogue, by one warp: its top-kk (pool positions in
// bd/bi [0, k), sorted) and its M edges merged as `_repair_rows` merges
// them, the first M written over the row.
__device__ void repair_row(const float* bd, const int* bi, float* md, int* mi,
                           long long slot, const long long* pool,
                           const unsigned char* dead, int* nb, float* nd,
                           int k, int M, int lane) {
  int p = 1;
  while (p < M + k) p <<= 1;
  int* row_i = nb + slot * M;
  float* row_d = nd + slot * M;
  for (int j = lane; j < p; j += 32) {
    float d = CUDART_INF_F;
    int id = -1;
    if (j < M) {  // an edge; to a deleted slot it drops
      const int e = row_i[j];
      const bool drop = e >= 0 && dead[e];
      d = drop ? CUDART_INF_F : row_d[j];
      id = drop ? -1 : e;
    } else if (j < M + k) {  // a candidate; the row itself is masked
      const int pos = bi[j - M];
      if (pos >= 0) {
        const long long s = pool[pos];
        if (s != slot) {
          d = bd[j - M];
          id = static_cast<int>(s);
        }
      }
    }
    md[j] = d;
    mi[j] = id;
  }
  __syncwarp();
  warp_sort<true>(md, mi, p, lane);
  // each id once, at its closest distance: later entries of an id drop
  bool dup[kMerge / 32];
#pragma unroll
  for (int u = 0; u < kMerge / 32; ++u) {
    const int j = lane + 32 * u;
    dup[u] = j > 0 && j < p && mi[j] >= 0 && mi[j] == mi[j - 1];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kMerge / 32; ++u) {
    if (dup[u]) {
      md[lane + 32 * u] = CUDART_INF_F;
      mi[lane + 32 * u] = -1;
    }
  }
  __syncwarp();
  warp_sort<false>(md, mi, p, lane);
  for (int j = lane; j < M; j += 32) {
    row_i[j] = mi[j];
    row_d[j] = md[j];
  }
  __syncwarp();
}

template <int TQ>
__global__ void __launch_bounds__(kThreads, 1)
delete_repair_kernel(const float* __restrict__ v,          // [H, D] rows by slot
                     const float* __restrict__ qn,         // [H] sqnorms (l2)
                     const long long* __restrict__ aff,    // [A] affected slots
                     const long long* __restrict__ pool,   // [P] pool slots
                     const long long* __restrict__ counts, // [2] rows in each
                     const float* __restrict__ c,          // [P, D] pool rows
                     const float* __restrict__ cp,         // [P] penalty row
                     const float* __restrict__ cs,         // [P] 1/|c| (cosine)
                     const unsigned char* __restrict__ dead,  // [cap] deleted
                     int* __restrict__ nb,                 // [cap, M] in place
                     float* __restrict__ nd,               // [cap, M] in place
                     int A, int P, int D, int k, int M, int mode,
                     int keep_if_empty, Plan plan, int vec) {
  using G = Geometry<TQ>;
  const int n_aff = static_cast<int>(min(static_cast<long long>(A), counts[0]));
  const int n_pool = static_cast<int>(min(static_cast<long long>(P), counts[1]));
  const int q0 = blockIdx.x * TQ;
  // nothing to refill from: the rows keep their edges where slots are never
  // taken again (JAX's rule), else they drop the dead ones below
  if (q0 >= n_aff || (n_pool == 0 && keep_if_empty)) return;

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
  const int qrow = warp * G::kRowsPerWarp + ly;
  const int live = min(TQ, n_aff - q0);

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
    rt[i] = mode == 1 ? 1.f : mode == 0 && r < live ? qn[aff[q0 + r]] : 0.f;
  }
  __syncthreads();

  const int nk = (D + kDepth - 1) / kDepth;
  const int steps = (n_pool + kTileRows - 1) / kTileRows * nk;
  const uint32_t stage_b = 4u * stage_words(TQ);
  auto fetch = [&](int g) {
    if (g < steps) {
      const int tile = g / nk, kc = g - tile * nk;
      load_stage<TQ>(ring + (g % stages) * stage_b, v, aff, c, q0, live,
                     tile * kTileRows, n_pool, kc * kDepth, D, vec, tid);
    }
    cp_commit();
  };
  for (int g = 0; g < stages - 1; ++g) fetch(g);

  float acc[G::kRq][G::kRc];
  int kc = 0, t0 = 0;
  for (int g = 0; g < steps; ++g) {
    if (stages == 4) cp_wait<2>();
    else if (stages == 3) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();
    fetch(g + stages - 1);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < G::kRq; ++i)
#pragma unroll
        for (int j = 0; j < G::kRc; ++j) acc[i][j] = 0.f;
    }
    const float* st = smem + (g % stages) * stage_words(TQ);
    multiply<TQ>(st, qrow, lx, acc);
    if (++kc == nk) {
      select_tile<TQ>(acc, rt, cp, cs, bd, bi, cnt, thr, k, W, mode, t0,
                      n_pool, qrow, live, ly, lx, lane);
      kc = 0;
      t0 += kTileRows;
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it is merge scratch now

  float* md = smem + warp * 2 * kMerge;
  int* mi = reinterpret_cast<int*>(md + kMerge);
  for (int rr = 0; rr < G::kRowsPerWarp; ++rr) {
    const int r = warp * G::kRowsPerWarp + rr;
    if (r >= live) break;
    const int n = cnt[r];
    if (n > 0) warp_merge(bd + (size_t)r * W, bi + (size_t)r * W, k, n, lane);
    repair_row(bd + (size_t)r * W, bi + (size_t)r * W, md, mi, aff[q0 + r],
               pool, dead, nb, nd, k, M, lane);
  }
}

struct Args {
  const float* v;
  const float* qn;
  const long long* aff;
  const long long* pool;
  const long long* counts;
  const float* c;
  const float* cp;
  const float* cs;
  const unsigned char* dead;
  int* nb;
  float* nd;
  int A, P, D, k, M, mode, keep_if_empty;
  Plan plan;
  cudaStream_t stream;
};

template <int TQ>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.plan);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      delete_repair_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = a.D % 4 == 0 && reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.c) % 16 == 0;
  const dim3 grid((a.A + TQ - 1) / TQ);
  delete_repair_kernel<TQ><<<grid, kThreads, smem, a.stream>>>(
      a.v, a.qn, a.aff, a.pool, a.counts, a.c, a.cp, a.cs, a.dead, a.nb, a.nd,
      a.A, a.P, a.D, a.k, a.M, a.mode, a.keep_if_empty, a.plan, vec);
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

bool plan_ok(int k, Plan p) {
  if (k < 1 || k > kMaxK || p.stages < kMinStages || p.stages > kMaxStages)
    return false;
  if (p.tq != 8 && p.tq != 16 && p.tq != 32 && p.tq != 64 && p.tq != 128)
    return false;
  return p.w >= k + check_cols(p.tq) && (p.w & (p.w - 1)) == 0;
}

}  // namespace

extern "C" {

int delete_repair_max_k() { return kMaxK; }

int delete_repair_max_merge() { return kMerge; }

// Bytes of dynamic shared memory a launch with this plan asks for.
long long delete_repair_smem_bytes(int tq, int w, int stages) {
  return (long long)smem_bytes(Plan{tq, w, stages});
}

const char* delete_repair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// v [H, D] f32 (cosine: unit rows), qn [H] f32 (read for l2), aff [A] and
// pool [P] int64 slots (ascending, -1 after the counts), counts [2] int64
// (affected rows, pool rows), c [P, D] f32 (the pool's rows), cp [P] f32,
// cs [P] f32 (read for cosine), dead [cap] bool, nb [cap, M] int32 and
// nd [cap, M] f32, updated in place; all contiguous, on card `device`.
// mode: 0 l2, 1 cosine, 2 inner product. keep_if_empty: with an empty
// pool the rows keep their edges. tq, w, stages: the wrapper's plan.
int delete_repair_launch(const void* v, const void* qn, const void* aff,
                         const void* pool, const void* counts, const void* c,
                         const void* cp, const void* cs, const void* dead,
                         void* nb, void* nd, int A, int P, int D, int k, int M,
                         int mode, int keep_if_empty, int tq, int w,
                         int stages, int device, void* stream) {
  const Plan p{tq, w, stages};
  if (A < 1 || P < 0 || D < 1 || M < 1 || M + k > kMerge || mode < 0 ||
      mode > 2 || !plan_ok(k, p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(v),
               static_cast<const float*>(qn),
               static_cast<const long long*>(aff),
               static_cast<const long long*>(pool),
               static_cast<const long long*>(counts),
               static_cast<const float*>(c),
               static_cast<const float*>(cp),
               static_cast<const float*>(cs),
               static_cast<const unsigned char*>(dead),
               static_cast<int*>(nb),
               static_cast<float*>(nd),
               A, P, D, k, M, mode, keep_if_empty, p,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_tile(a));
}

}  // extern "C"
