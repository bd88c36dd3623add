// Smallest-k over a corpus on Hopper's tensor cores: the bf16-operand and
// int8 modes of flat_topk, with the running top-k kept beside the wgmma
// accumulators, so the [B, N] distance matrix never reaches device memory.
//
// Replaces: muninn_tpu/ops/pallas_flat.py `_flat_topk_kernel`, its float
// branch (pallas_flat.py:49) at precision="default"/"bfloat16" (launched by
// `flat_topk`, :344), and its int8 branch (:74-88, launched by
// `flat_topk_int8`, :452, and by `flat_topk` at precision="int8"). The
// f32 `highest` mode stays on CUDA cores (csrc/flat_topk.cu): it promises
// exact f32 ranking, which no tensor-core type gives.
//
// Operand modes (template parameter kOp):
//   bf16 (1)  the unit query and the raw corpus row, each rounded to bf16
//             (round to nearest even), multiplied on the tensor cores with
//             f32 sums (wgmma m64n128k16.f32.bf16.bf16). A product of two
//             bf16 values is exact in f32, so this mode and its plain
//             version differ only in summation order. The wrapper rounds
//             both sides (`mma_rows`): the f32 store is copied to bf16 once
//             per call, so the index keeps no bf16 shadow. The epilogue (qn,
//             the penalty row, 1/|c|) stays f32 from the unrounded rows:
//               l2 (qn - 2*dot) + cp;  cosine (1 - dot*cs) + cp;  ip cp - dot
//   int8 (2)  int8 query and corpus rows (symmetric per-row quantization),
//             an exact s32 dot (wgmma m64n128k32.s32.s8.s8), then the
//             rank-only tile of the TPU kernel, __fsub_rn(cp, __fmul_rn(
//             f32(dot), cs)), each step rounded as the plain version rounds
//             it, so kernel and plain distances are bitwise equal. The
//             wrapper rescales the k survivors (`_int8_emit`).
// cp[n] is the penalty row: the l2 corpus sqnorm (0 otherwise) and +inf on
// masked rows, so masking and the metric term are one add.
//
// What bounds it on an H100: the tensor cores at large B (989 TFLOP/s bf16,
// 1,979 TOP/s int8, dense, 700 W), the corpus read from HBM at small B.
// Before either, the corpus's trips from L2 to the SMs (every query tile
// reads all of it) and the epilogue's passes over each tile. What the
// design does about it:
//   - One block holds TQ queries (128 as two consumer warpgroups of 64, or
//     64 down to 8 in one warpgroup when k is large) and walks its share of
//     the corpus in tiles of 128 rows. The query tile stays resident in
//     shared memory where it fits (else it streams beside the corpus); the
//     corpus streams through a ring of 2-6 stages of 128 bytes of K, in the
//     128-byte swizzled K-major layout that wgmma reads through its
//     descriptors. One thread of a producer warpgroup fills the ring with
//     the tensor memory accelerator (2D tensor maps, cp.async.bulk.tensor),
//     full and empty mbarriers, so loads of later stages overlap the MMAs;
//     an int8 corpus whose rows are not 16-byte aligned (d % 16 != 0) is
//     loaded by the producer's 128 threads instead.
//   - Grid order is query tiles fastest, then corpus splits, so the blocks
//     in flight walk the same corpus range together and the re-reads hit
//     L2. When the query tiles alone cannot fill the card, the corpus is
//     split (occupancy API) and the wrapper merges the [S, B, k] partials.
//   - The top-k beside the accumulators: each warp owns 16 query rows of
//     the 64 x 128 accumulator tile (a thread holds 2 rows x 32 columns).
//     It turns all its values into distances in place, with no branch, and
//     one vote ends the tile when none beats its row's threshold (the k-th
//     best at the last merge). Otherwise, 16 columns at a time, the passing
//     values are appended to their rows' candidate regions with a shared
//     atomicAdd, after sorting (top-k + candidates) and keeping the first k
//     where a region would overflow: in registers with warp shuffles up to
//     64 entries, in shared memory above. Rows belong to one warp, so no
//     block barrier is needed after the start. The per-query buffer is
//     W = pow2(k + 16) entries; TQ shrinks as W grows so the buffers stay
//     within 64 KB (128 KB at k > 1008).
//   - Ragged B, N and d: rows past B or N arrive as zeros from the tensor
//     maps (or the loader) and are never reported; corpus rows past the
//     split carry cp = +inf; K past d is zero in both operands (the wrapper
//     pads the queries and the bf16 corpus), and a zero adds nothing to a
//     dot.
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "topk_merge.cuh"  // before(), warp_merge()

namespace {

constexpr int kOpBf16 = 1, kOpInt8 = 2;  // operand modes, as flat_topk.py
constexpr int kMaxK = 1024;         // largest k the kernel serves
constexpr int kMaxSplits = 256;     // most corpus splits for one query tile
constexpr int kTileRows = 128;      // corpus rows per tile: the wgmma N
constexpr int kChunk = 128;         // bytes of K per stage: 64 bf16, 128 int8
constexpr int kCheck = 16;          // columns between candidate-region checks
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Accumulator of a mode: f32 sums of bf16 products, or exact s32 dots.
template <int kOp>
using Acc = typename std::conditional<kOp == kOpInt8, int, float>::type;

// The wrapper's plan (flat_topk.py `mma_plan`): queries per block, buffer
// width, ring depth, and the query chunks kept resident (0: the queries
// stream through the ring beside the corpus).
struct Plan {
  int tq, w, stages, a_chunks;
};

// Shared memory, in bytes from a 1024-byte aligned base (the swizzle is
// computed from address bits 4-9, so every 8-row atom starts aligned):
//   resident queries [a_chunks][64*NC rows][128 B]
//   stage s: (streamed queries [64*NC rows][128 B]) | corpus [128 rows]
//            [128 B] | cp [128] | cs [128]
//   full[stages], empty[stages], queries-in mbarriers, in a 128-byte slot
//   bd [TQ][W] f32, bi [TQ][W] int32: per query, top-k in [0, k),
//   candidates after; cnt [TQ] candidates waiting; thr [TQ] threshold;
//   per consumer warpgroup, the epilogue's tile penalty and scale [2][128]
__host__ __device__ constexpr int stage_bytes(int nc, bool streamed) {
  return ((streamed ? 64 * nc : 0) + kTileRows) * kChunk + 2 * kTileRows * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int nc, Plan p) {
  return (size_t)p.a_chunks * 64 * nc * kChunk +
         (size_t)p.stages * stage_bytes(nc, p.a_chunks == 0) + 128 +
         (size_t)p.tq * p.w * 8 + (size_t)p.tq * 8 + (size_t)nc * 1024 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Row r, 16-byte chunk c of a 128-byte swizzled K-major tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kChunk + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major, 128-byte swizzled operand:
// start address, leading offset 16 B (unused by swizzled K-major), stride
// 1024 B between 8-row atoms, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// One arrival that also expects `bytes` from the tensor memory accelerator.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait of about ten
// seconds means an arrival was lost: trap, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}
// Order this thread's generic-proxy shared memory accesses with the async
// proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// One box of a 2D tensor map (x: byte within a row, y: row) into shared
// memory, in the map's 128-byte swizzle; rows and bytes outside the tensor
// arrive as zeros. Completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Barrier of consumer warpgroup g's 128 threads (named barrier 1 + g).
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
}

#define ACC8(C, i)                                                   \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),       \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define ACC64(C)                                                     \
  ACC8(C, 0), ACC8(C, 8), ACC8(C, 16), ACC8(C, 24), ACC8(C, 32),     \
      ACC8(C, 40), ACC8(C, 48), ACC8(C, 56)
#define REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64x128] (+)= A[64 x 32 B] * B[128 x 32 B]^T: 16 bf16 or 32 int8 of K.
// scale_d 0 starts the sums afresh.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REGS64
      ", %64, %65, p;\n}\n"
      : ACC64("+r")
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMA's start and its wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Bytes b0..b0+15 of a corpus row that a tensor map cannot read (nullptr: a
// row past the split); bytes at or past `len` are 0. words: rows are
// 4-byte aligned, so whole words load at once.
__device__ __forceinline__ uint4 bytes16(const uint8_t* row, int b0, int len,
                                         bool words) {
  uint32_t w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int f = b0 + 4 * t;
    w[t] = 0;
    if (row == nullptr || f >= len) continue;
    if (words && f + 4 <= len) {
      w[t] = __ldg(reinterpret_cast<const unsigned int*>(row + f));
    } else {
      for (int u = 0; u < 4 && f + u < len; ++u)
        w[t] |= static_cast<uint32_t>(row[f + u]) << (8 * u);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A distance kept in an accumulator register: the sums are dead once read.
__device__ __forceinline__ void put(float& a, float d) { a = d; }
__device__ __forceinline__ void put(int& a, float d) { a = __float_as_int(d); }
__device__ __forceinline__ float get(float a) { return a; }
__device__ __forceinline__ float get(int a) { return __int_as_float(a); }

// One warp's part of a tile's epilogue: its `nvalid` rows row0.. of the
// block, the thread's accumulator fragment (rows row0 + lane/4 and + 8,
// columns 8i + 2(lane%4) + {0, 1}), corpus rows t0..t0+127 with their
// penalty cpS and column scale csS. All 64 distances come first, with no
// branch, in place of the sums; a tile where no value beats its row's
// threshold (most of them, once the thresholds settle) ends at one vote.
//   bf16: (rt + dot * cs) + cp, with rt the row term (qn for l2, 1 for
//         cosine, 0 for inner product) and cs the column scale (-2, -1/|c|,
//         -1): the three distances of the header in one form
//   int8: the rank-only tile cp - f32(dot) * cs, each step rounded
template <int kOp>
__device__ __forceinline__ void epilogue(
    Acc<kOp> (&acc)[64], const float* cpS, const float* csS, float* bd,
    int* bi, int* cnt, float* thr, int k, int W, int t0, int row0,
    int nvalid, int lane, float rtA, float rtB) {
  constexpr unsigned kAll = 0xffffffffu;
  const int cap = W - k;
  const int rA = row0 + (lane >> 2), rB = rA + 8;
  const bool vA = (lane >> 2) < nvalid, vB = (lane >> 2) + 8 < nvalid;
  // thresholds of the thread's two rows; -inf: not a live row, never passes
  float tA = vA ? thr[rA] : -CUDART_INF_F;
  float tB = vB ? thr[rB] : -CUDART_INF_F;
  unsigned long long pass = 0;  // bit 4i + e: value e of column group i
#pragma unroll
  for (int i = 0; i < kTileRows / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    const float2 p = *reinterpret_cast<const float2*>(cpS + col);
    const float2 c = *reinterpret_cast<const float2*>(csS + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = (e & 1) ? p.y : p.x, ce = (e & 1) ? c.y : c.x;
      float d;
      if constexpr (kOp == kOpInt8)
        d = __fsub_rn(pe, __fmul_rn(__int2float_rn(acc[4 * i + e]), ce));
      else
        d = fmaf(acc[4 * i + e], ce, e < 2 ? rtA : rtB) + pe;
      put(acc[4 * i + e], d);
      // strict: a row tied with the threshold has a larger id than the
      // entry that set it, so it would not enter. +inf (masked) and NaN
      // never pass.
      if (d < (e < 2 ? tA : tB)) pass |= 1ull << (4 * i + e);
    }
  }
  if (!__any_sync(kAll, pass != 0)) return;
#pragma unroll
  for (int ch = 0; ch < kTileRows / kCheck; ++ch) {
    constexpr int kBits = 4 * kCheck / 8;  // a thread's values per chunk
    unsigned bits = (unsigned)(pass >> (kBits * ch)) & ((1u << kBits) - 1);
    if (!__any_sync(kAll, bits != 0)) continue;
    // this chunk's candidates of each row, summed over the quad of lanes
    // that holds the row; a row whose region would overflow merges first
    int na = __popc(bits & 0x33u), nb = __popc(bits & 0xCCu);
    na += __shfl_xor_sync(kAll, na, 1);
    na += __shfl_xor_sync(kAll, na, 2);
    nb += __shfl_xor_sync(kAll, nb, 1);
    nb += __shfl_xor_sync(kAll, nb, 2);
    __syncwarp();  // the previous chunk's appends are in place
    const bool needA = na > 0 && cnt[rA] + na > cap;
    const bool needB = nb > 0 && cnt[rB] + nb > cap;
    if (__any_sync(kAll, needA || needB)) {
      for (int rr = 0; rr < 16; ++rr) {
        if (__shfl_sync(kAll, rr < 8 ? needA : needB, 4 * (rr & 7))) {
          const int r = row0 + rr;
          const float t = warp_merge(bd + (size_t)r * W, bi + (size_t)r * W,
                                     k, cnt[r], lane);
          if (lane == 0) {
            cnt[r] = 0;
            thr[r] = t;
          }
          __syncwarp();
        }
      }
      // the new thresholds, for this chunk and the ones after it
      tA = vA ? thr[rA] : -CUDART_INF_F;
      tB = vB ? thr[rB] : -CUDART_INF_F;
      pass = 0;
#pragma unroll
      for (int j = 0; j < 64; ++j)
        if (get(acc[j]) < ((j & 3) < 2 ? tA : tB)) pass |= 1ull << j;
      bits = (unsigned)(pass >> (kBits * ch)) & ((1u << kBits) - 1);
    }
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      if (bits & (1u << b)) {
        const int j = kBits * ch + b;
        const int r = (j & 3) < 2 ? rA : rB;
        const int pos = atomicAdd(&cnt[r], 1);
        bd[(size_t)r * W + k + pos] = get(acc[j]);
        bi[(size_t)r * W + k + pos] = t0 + 8 * (j / 4) + 2 * (lane & 3) + (j & 1);
      }
    }
  }
}

template <int kOp, int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flat_topk_mma_kernel(const __grid_constant__ CUtensorMap map_q,  // [B, n_chunks*128 B]
                     const __grid_constant__ CUtensorMap map_c,  // [N, len B]
                     const void* __restrict__ cv,   // [N, len B] bf16, int8
                     const float* __restrict__ qn,  // [B] query sqnorms (l2)
                     const float* __restrict__ cp,  // [N] penalty row
                     const float* __restrict__ cs,  // [N] 1/|c| (cosine), or
                                                    // the int8 scales
                     float* __restrict__ out_d,     // [S, B, k]
                     int* __restrict__ out_i,       // [S, B, k]
                     int B, int N, int len, int k, int mode,
                     int rows_per_split, Plan plan, int n_chunks, int path) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tq = plan.tq, W = plan.w, stages = plan.stages;
  const bool resident = plan.a_chunks > 0;
  constexpr int kAChunk = 64 * NC * kChunk;  // one K chunk of the query tile
  const int sb = stage_bytes(NC, !resident);
  const uint32_t a_res = smem_u32(smem);     // resident queries
  const int ring = plan.a_chunks * kAChunk;  // offset of stage 0
  const uint32_t stage0 = a_res + ring;
  const int bq = resident ? 0 : kAChunk;     // corpus offset in a stage
  // full[s], then empty[s], then the resident queries' barrier
  const uint32_t bars = stage0 + stages * sb;
  const uint32_t a_bar = bars + 16 * stages;
  float* bd = reinterpret_cast<float*>(smem + ring + stages * sb + 128);
  int* bi = reinterpret_cast<int*>(bd + (size_t)tq * W);
  int* cnt = bi + (size_t)tq * W;
  float* thr = reinterpret_cast<float*>(cnt + tq);
  float* tile_cs = thr + tq;  // [NC][2][128]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * tq;
  const int split = blockIdx.y;
  const int row_lo = min(split * rows_per_split, N);
  const int row_hi = min(row_lo + rows_per_split, N);
  const int live = min(tq, B - q0);  // query rows of this block

  for (int e = tid; e < tq * W; e += blockDim.x) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  for (int r = tid; r < tq; r += blockDim.x) {
    cnt[r] = 0;
    thr[r] = CUDART_INF_F;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 128 + 1);  // full: producer threads, and
                                         // the bytes thread 0 expects
      mbar_init(bars + 8 * (stages + s), 4 * NC);  // empty: consumer warps
    }
    mbar_init(a_bar, 1);  // resident queries: one arrival, their bytes
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // From here on the roles never meet at a block barrier.

  if (warp >= 4 * NC) {
    // ── producer warpgroup: fill the ring ──
    const int pt = tid - 128 * NC;
    // the epilogue's column scale: the int8 scales; for bf16 -2 (l2),
    // -1/|c| (cosine), -1 (inner product)
    const float scale = mode == 0 ? -2.f : -1.f;
    // bytes thread 0 expects per stage: the query chunk when it streams,
    // the corpus chunk when the map can read it
    const int tx = (resident ? 0 : kAChunk) + (path == 2 ? kTileRows * kChunk : 0);
    if (pt == 0) {
      // the whole query tile once, chunk by chunk
      mbar_arrive_tx(a_bar, resident ? plan.a_chunks * kAChunk : 0);
      for (int kc = 0; kc < plan.a_chunks; ++kc)
        tma_load(a_res + kc * kAChunk, &map_q, kc * kChunk, q0, a_bar);
    }
    int s = 0, ph = 0;
    for (int t0 = row_lo; t0 < row_hi; t0 += kTileRows) {
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(bars + 8 * (stages + s), ph ^ 1);
        unsigned char* st = smem + ring + s * sb;
        const uint32_t st_u = stage0 + s * sb;
        const uint32_t b_u = st_u + bq;
        unsigned char* b_p = st + bq;
        if (pt == 0 && tx > 0) {
          mbar_arrive_tx(bars + 8 * s, tx);
          if (!resident) tma_load(st_u, &map_q, kc * kChunk, q0, bars + 8 * s);
          // path 2: rows 16-byte aligned, read through the map (rows of the
          // next split are masked by cp = +inf below); else loaded here
          if (path == 2)
            tma_load(b_u, &map_c, kc * kChunk, t0, bars + 8 * s);
        } else if (pt == 0) {
          mbar_arrive(bars + 8 * s);
        }
        if (path != 2) {
          const uint8_t* corpus = static_cast<const uint8_t*>(cv);
          const int c = pt & 7;
          const int b0 = kc * kChunk + c * 16;
#pragma unroll 4
          for (int j = 0; j < kTileRows / 16; ++j) {
            const int r = (pt >> 3) + 16 * j;
            const int gr = t0 + r;
            const uint8_t* row =
                gr < row_hi ? corpus + (size_t)gr * len : nullptr;
            *reinterpret_cast<uint4*>(b_p + swz(r, c)) =
                bytes16(row, b0, len, path == 1);
          }
        }
        if (kc == n_chunks - 1) {
          // the tile's penalty and scale, read by the epilogue
          float* cpS = reinterpret_cast<float*>(b_p + kTileRows * kChunk);
          const int gr = t0 + pt;
          const bool in = gr < row_hi;
          cpS[pt] = in ? cp[gr] : CUDART_INF_F;
          cpS[kTileRows + pt] = !in               ? 0.f
                                : kOp == kOpInt8  ? cs[gr]
                                : mode == 1       ? -cs[gr]
                                                  : scale;
        }
        // stores the MMA reads through the async proxy: fence them first
        if (path != 2) fence_async_smem();
        mbar_arrive(bars + 8 * s);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ── consumer warpgroups: MMA, then the top-k epilogue ──
    const int g = warp >> 2;
    const int row0 = 64 * g + 16 * (warp & 3);  // this warp's block rows
    const int nvalid = max(0, min(16, live - row0));
    const int rA = row0 + (lane >> 2);
    // the bf16 epilogue's row terms: qn for l2, 1 for cosine, 0 for ip
    float rtA = mode == 1 ? 1.f : 0.f, rtB = rtA;
    if (kOp == kOpBf16 && mode == 0) {
      if (rA < live) rtA = qn[q0 + rA];
      if (rA + 8 < live) rtB = qn[q0 + rA + 8];
    }
    Acc<kOp> acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    mbar_wait(a_bar, 0);
    int s = 0, ph = 0;
    for (int t0 = row_lo; t0 < row_hi; t0 += kTileRows) {
      int last = 0;
      fence_acc(acc);
      for (int kc = 0; kc < n_chunks; ++kc) {
        mbar_wait(bars + 8 * s, ph);
        wgmma_fence();
        const uint32_t a_u = (resident ? a_res + kc * kAChunk : stage0 + s * sb) +
                             g * 64 * kChunk;
        const uint32_t b_u = stage0 + s * sb + bq;
#pragma unroll
        for (int ks = 0; ks < kChunk / 32; ++ks)
          mma(acc, desc(a_u + 32 * ks), desc(b_u + 32 * ks), (kc | ks) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        // hand the buffer back at once; the tile's last one after its
        // penalty and scale are copied out
        if (kc + 1 < n_chunks) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (stages + s));
        }
        last = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
      fence_acc(acc);
      float* mine = tile_cs + g * 2 * kTileRows;
      const float* cpS = reinterpret_cast<const float*>(
          smem + ring + last * sb + bq + kTileRows * kChunk);
      const int tw = tid & 127;
      wg_sync(g);  // this warpgroup's last epilogue is done with `mine`
      mine[tw] = cpS[tw];
      mine[kTileRows + tw] = cpS[kTileRows + tw];
      wg_sync(g);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (stages + last));
      if (nvalid > 0)
        epilogue<kOp>(acc, mine, mine + kTileRows, bd, bi, cnt, thr, k, W, t0,
                      row0, nvalid, lane, rtA, rtB);
    }

    __syncwarp();
    for (int rr = 0; rr < nvalid; ++rr) {
      const int r = row0 + rr;
      const int n = cnt[r];
      if (n > 0) warp_merge(bd + (size_t)r * W, bi + (size_t)r * W, k, n, lane);
      const size_t o = ((size_t)split * B + q0 + r) * k;
      for (int j = lane; j < k; j += 32) {
        out_d[o + j] = bd[(size_t)r * W + j];
        out_i[o + j] = bi[(size_t)r * W + j];
      }
      __syncwarp();
    }
  }
}

// One launch's operands and sizes, as the C interface receives them.
struct Args {
  const void* q;  // [B, n_chunks * 128 bytes]
  const void* c;
  const float* qn;
  const float* cp;
  const float* cs;
  float* out_d;
  int* out_i;
  int B, N, len, k, mode;  // len: corpus row bytes
  Plan plan;
  int splits;
  cudaStream_t stream;
};

// The instance for a query tile: two consumer warpgroups at 128 queries.
template <int kOp, int NC>
cudaError_t prepare(Plan p, int* per_sm) {
  const size_t smem = smem_bytes(NC, p);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flat_topk_mma_kernel<kOp, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, flat_topk_mma_kernel<kOp, NC>, (NC + 1) * 128, smem);
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime, so this
// library links no libcuda of its own.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2D map of `rows` rows of `row_bytes` bytes (a multiple of 16) read in
// boxes of box_rows x 128 bytes, 128-byte swizzled as wgmma reads them.
cudaError_t byte_map(CUtensorMap* map, const void* base, int row_bytes,
                     int rows, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kOp, int NC>
cudaError_t launch(const Args& a) {
  cudaError_t err = prepare<kOp, NC>(a.plan, nullptr);
  if (err != cudaSuccess) return err;
  // rows per split: a whole number of tiles; trailing splits may be empty
  const int per = (a.N + a.splits - 1) / a.splits;
  const int rows = (per + kTileRows - 1) / kTileRows * kTileRows;
  const uintptr_t cb = reinterpret_cast<uintptr_t>(a.c);
  const int path = a.len % 16 == 0 && cb % 16 == 0 ? 2
                   : a.len % 4 == 0 && cb % 4 == 0 ? 1 : 0;
  const int n_chunks = (a.len + kChunk - 1) / kChunk;
  // the queries are padded to whole chunks; the corpus map only where its
  // rows are 16-byte aligned (and there are rows)
  CUtensorMap map_q, map_c;
  err = byte_map(&map_q, a.q, n_chunks * kChunk, a.B, 64 * NC);
  if (err == cudaSuccess)
    err = path == 2 && a.N > 0 ? byte_map(&map_c, a.c, a.len, a.N, kTileRows)
                               : byte_map(&map_c, a.q, n_chunks * kChunk, a.B,
                                          kTileRows);  // unused
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + a.plan.tq - 1) / a.plan.tq, a.splits);
  flat_topk_mma_kernel<kOp, NC>
      <<<grid, (NC + 1) * 128, smem_bytes(NC, a.plan), a.stream>>>(
          map_q, map_c, a.c, a.qn, a.cp, a.cs, a.out_d, a.out_i, a.B, a.N,
          a.len, a.k, a.mode, rows, a.plan, n_chunks, path);
  return cudaGetLastError();
}

// A plan the kernel serves for k and n_chunks of K: a query tile of 8-128,
// a power-of-two buffer width holding k plus at least one check's columns,
// 2-6 stages, all the query chunks resident or none.
bool plan_ok(int k, int n_chunks, Plan p) {
  if (k < 1 || k > kMaxK || p.stages < 2 || p.stages > kMaxStages)
    return false;
  if (p.tq != 8 && p.tq != 16 && p.tq != 32 && p.tq != 64 && p.tq != 128)
    return false;
  if (p.w < k + kCheck || (p.w & (p.w - 1)) != 0) return false;
  return p.a_chunks == 0 || p.a_chunks == n_chunks;
}

int chunks_of(int op, int D) {
  return ((op == kOpBf16 ? 2 : 1) * D + kChunk - 1) / kChunk;
}

}  // namespace

extern "C" {

int flat_topk_mma_max_k() { return kMaxK; }

// Bytes of dynamic shared memory a launch with this plan asks for (one
// consumer warpgroup below 128 queries, two at 128).
long long flat_topk_mma_smem_bytes(int tq, int w, int stages, int a_chunks) {
  return (long long)smem_bytes(tq == 128 ? 2 : 1,
                               Plan{tq, w, stages, a_chunks});
}

// How many corpus splits to give the launcher on card `device`: as many as
// keep query tiles x splits within one wave of resident blocks, at least
// 8 tiles of corpus rows per split, at most kMaxSplits, at least 1. Returns
// -(CUDA error) if the plan is refused or the card cannot be queried.
int flat_topk_mma_splits(int B, int N, int D, int k, int op, int tq, int w,
                         int stages, int a_chunks, int device) {
  const Plan p{tq, w, stages, a_chunks};
  if (B < 1 || D < 1 || (op != kOpBf16 && op != kOpInt8) ||
      !plan_ok(k, chunks_of(op, D), p))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    if (op == kOpInt8)
      err = tq == 128 ? prepare<kOpInt8, 2>(p, &per_sm)
                      : prepare<kOpInt8, 1>(p, &per_sm);
    else
      err = tq == 128 ? prepare<kOpBf16, 2>(p, &per_sm)
                      : prepare<kOpBf16, 1>(p, &per_sm);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int qtiles = (B + tq - 1) / tq;
  int s = per_sm * sms / qtiles;
  const int by_rows = N / (8 * kTileRows);
  if (s > by_rows) s = by_rows;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

const char* flat_topk_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, n_chunks * 128 bytes] and c [N, D]: bf16 (op 1) or int8 (op 2),
// n_chunks = ceil(D * element bytes / 128), queries zero past D; qn [B] f32
// (read for l2),
// cp [N] f32, cs [N] f32 (read for cosine, and for int8 as the corpus
// scales), out_d/out_i [splits, B, k] f32/int32; all contiguous, on card
// `device`. mode: 0 l2, 1 cosine, 2 inner product (int8: 1 or 2, the same
// rank-only tile). tq, w, stages: the wrapper's plan.
int flat_topk_mma_launch(const void* q, const void* c, const void* qn,
                         const void* cp, const void* cs, void* out_d,
                         void* out_i, int B, int N, int D, int k, int mode,
                         int op, int tq, int w, int stages, int a_chunks,
                         int splits, int device, void* stream) {
  const Plan p{tq, w, stages, a_chunks};
  if (B < 1 || N < 0 || D < 1 || mode < 0 || mode > 2 ||
      (op != kOpBf16 && op != kOpInt8) || (op == kOpInt8 && mode == 0) ||
      splits < 1 || splits > kMaxSplits || !plan_ok(k, chunks_of(op, D), p))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, c, static_cast<const float*>(qn),
               static_cast<const float*>(cp), static_cast<const float*>(cs),
               static_cast<float*>(out_d), static_cast<int*>(out_i),
               B, N, op == kOpBf16 ? 2 * D : D, k, mode, p, splits,
               static_cast<cudaStream_t>(stream)};
  if (op == kOpInt8)
    err = tq == 128 ? launch<kOpInt8, 2>(a) : launch<kOpInt8, 1>(a);
  else
    err = tq == 128 ? launch<kOpBf16, 2>(a) : launch<kOpBf16, 1>(a);
  return static_cast<int>(err);
}

}  // extern "C"
