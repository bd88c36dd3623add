// Block-row scoring for the HNSW beam kernels (csrc/beam_dots.cu in its
// dots and top-m modes, csrc/beam_loop.cu, csrc/beam_step.cu): the dot of
// an f32 query with, and the squared norm of, many stored rows (f32, bf16
// or int8), summed in f32 with fmaf; int8 squared norms are exact integers
// (__dp4a).
//
// Layout: a row is `units` loads of 16 bytes (`vec`: the row starts 16-byte
// aligned and D * sizeof(T) is a multiple of 16), else of one element. L
// lanes of a warp share a row, L the least of 4, 8, 16 and 32 whose passes
// of kUnits units a lane cover the row (`lanes_log2`; at D = 384 and four
// units, 8 lanes for an int8 row, 16 for bf16, 32 for f32, three units
// each), so every lane of a warp loads and a warp holds 32 / L rows. Each
// warp takes kGroups such groups at once and issues all of their loads
// before any multiply-add; a
// lane's units are the same in every row it takes, so one read of its
// query slice serves them all. One log2(L)-step shuffle tree then sums every
// row of the warp at once.
//
// What the callers supply: `row_of(r)`, the address of row r, or nullptr
// for a row that must not be read (a dead or out-of-range pick: no load,
// and (dot, sq) = (0, 0)); `emit(r, dot, sq, loaded)`, called once per row,
// on one lane of its group (`loaded`: row_of gave an address).
//
// Included by beam_dots.cu, beam_loop.cu and beam_step.cu; `_build.py`
// hashes this header with each source, so a change here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace block_rows {

// log2 of the lanes that share a row of `units` loads, each lane taking
// at most `per_lane` of them a pass where 32 lanes allow (see the header).
__host__ __device__ inline int lanes_log2(int units, int per_lane) {
  int lg = 2;
  while (lg < 5 && units > (per_lane << lg)) ++lg;
  return lg;
}

// The launcher's row geometry for rows of T starting at `packed`: `vec`,
// 16-byte loads (the table 16-byte aligned and D * sizeof(T) a multiple of
// 16), and `lg`, lanes_log2 at `per_lane` loads a lane. A row's sum order
// follows from these alone, so kernels that take the same geometry sum a
// row alike (beam_dots.cu and beam_step.cu: 8 loads a lane).
template <typename T>
inline void geometry(const void* packed, int D, int per_lane, int& vec, int& lg) {
  vec = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && ((size_t)D * sizeof(T)) % 16 == 0;
  lg = lanes_log2(vec ? D / (16 / (int)sizeof(T)) : D, per_lane);
}

// The metric over one row's (dot, cn2), as ops/beam.py packed_distances
// writes it, one rounding per step (no FMA contraction): l2
// max((qn2 + cn2) - 2 dot, 0); cosine 1 - dot / max(|q||c|, 1e-30),
// similarity 0 below the guard; inner product -dot. mode: 0 l2, 1 cosine,
// 2 inner product.
__device__ __forceinline__ float metric_distance(float dot, float cn2,
                                                 float qn2, int mode) {
  if (mode == 2) return -dot;
  if (mode == 0)
    return fmaxf(__fsub_rn(__fadd_rn(qn2, cn2), __fmul_rn(2.f, dot)), 0.f);
  const float denom = __fmul_rn(sqrtf(qn2), sqrtf(cn2));
  const float sim = denom < 1e-30f ? 0.f : __fdiv_rn(dot, fmaxf(denom, 1e-30f));
  return __fsub_rn(1.f, sim);
}

// Per element type: the squared norm's accumulator, and one load's
// contribution to (dot, sq) against the query floats `q` of its elements
// (registers, read once for every row of the pass).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Sq = float;
  __device__ static void add(const uint4& w, const float* q, float& dot, float& sq) {
    const float x[4] = {__uint_as_float(w.x), __uint_as_float(w.y),
                        __uint_as_float(w.z), __uint_as_float(w.w)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      dot = fmaf(x[t], q[t], dot);
      sq = fmaf(x[t], x[t], sq);
    }
  }
  __device__ static void add(float x, float q, float& dot, float& sq) {
    dot = fmaf(x, q, dot);
    sq = fmaf(x, x, sq);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Sq = float;
  // the low half of each word is the lower element (little-endian)
  __device__ static void add(const uint4& w, const float* q, float& dot, float& sq) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x[4] = {__uint_as_float(u[2 * h] << 16),
                          __uint_as_float(u[2 * h] & 0xffff0000u),
                          __uint_as_float(u[2 * h + 1] << 16),
                          __uint_as_float(u[2 * h + 1] & 0xffff0000u)};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dot = fmaf(x[t], q[4 * h + t], dot);
        sq = fmaf(x[t], x[t], sq);
      }
    }
  }
  __device__ static void add(__nv_bfloat16 e, float q, float& dot, float& sq) {
    const float x = __bfloat162float(e);
    dot = fmaf(x, q, dot);
    sq = fmaf(x, x, sq);
  }
};

template <>
struct Elem<int8_t> {
  using Sq = int;  // exact: 127^2 * D < 2^31
  // Each byte b as the float 2^23 + (b + 128) (its biased value placed in
  // the mantissa by a byte permute), less 2^23 + 128: exactly b, with no
  // int-to-float conversion. The squared norm is __dp4a's integer sum.
  __device__ static void add(const uint4& w, const float* q, float& dot, int& sq) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t biased = u[i] ^ 0x80808080u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float x =
            __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7440u + t)) - 8388736.f;
        dot = fmaf(x, q[4 * i + t], dot);
      }
      sq = __dp4a(static_cast<int>(u[i]), static_cast<int>(u[i]), sq);
    }
  }
  __device__ static void add(int8_t e, float q, float& dot, int& sq) {
    dot = fmaf(static_cast<float>(e), q, dot);
    sq += static_cast<int>(e) * static_cast<int>(e);
  }
};

// The loads of one row: 16-byte units (kVec) or single elements.
template <typename T, bool kVec>
struct Load {
  using Word = typename std::conditional<kVec, uint4, T>::type;
  static constexpr int kElems = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
};

template <typename T, bool kVec, int kGroups, int kUnits, typename RowOf,
          typename Emit>
__device__ __forceinline__ void score_rows_as(const float* __restrict__ q,
                                              int nrows, int units, int lg,
                                              int warp, int nwarps, int lane,
                                              RowOf row_of, Emit emit) {
  using L = Load<T, kVec>;
  using W = typename L::Word;
  using Sq = typename Elem<T>::Sq;
  const int lanes = 1 << lg, per_group = 32 >> lg;
  const int li = lane & (lanes - 1), gl = lane >> lg;
  const int per_warp = per_group * kGroups;  // rows a warp takes at once
  for (int base = warp * per_warp; base < nrows; base += nwarps * per_warp) {
    const W* src[kGroups];
    int row[kGroups];
    float dot[kGroups];
    Sq sq[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      row[g] = base + g * per_group + gl;
      src[g] = row[g] < nrows ? reinterpret_cast<const W*>(row_of(row[g])) : nullptr;
      dot[g] = 0.f;
      sq[g] = 0;
    }
    for (int c = 0; c < units; c += kUnits * lanes) {  // one pass, unless D is large
      W w[kGroups][kUnits];
#pragma unroll
      for (int s = 0; s < kUnits; ++s) {
        const int u = c + s * lanes + li;
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (src[g] != nullptr && u < units) w[g][s] = __ldg(src[g] + u);
      }
#pragma unroll
      for (int s = 0; s < kUnits; ++s) {
        const int u = c + s * lanes + li;
        if (u >= units) continue;
        if constexpr (kVec) {
          float qu[L::kElems];
#pragma unroll
          for (int h = 0; h < L::kElems / 4; ++h) {
            const float4 t = reinterpret_cast<const float4*>(q + u * L::kElems)[h];
            qu[4 * h] = t.x;
            qu[4 * h + 1] = t.y;
            qu[4 * h + 2] = t.z;
            qu[4 * h + 3] = t.w;
          }
#pragma unroll
          for (int g = 0; g < kGroups; ++g)
            if (src[g] != nullptr) Elem<T>::add(w[g][s], qu, dot[g], sq[g]);
        } else {
          const float qu = q[u];
#pragma unroll
          for (int g = 0; g < kGroups; ++g)
            if (src[g] != nullptr) Elem<T>::add(w[g][s], qu, dot[g], sq[g]);
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        sq[g] += __shfl_xor_sync(0xffffffffu, sq[g], off);
      }
    }
    if (li == 0) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        if (row[g] < nrows)
          emit(row[g], dot[g], static_cast<float>(sq[g]), src[g] != nullptr);
    }
  }
}

// Score rows [0, nrows) with warps `warp` of `nwarps` (see the header),
// kUnits loads a lane and row in a pass. `q`: the query's D floats,
// 16-byte aligned; `vec` and `lg` as the launcher chose them (`units` =
// D / (16 / sizeof(T)) when vec, else D; lg = lanes_log2(units, kUnits)).
template <typename T, int kGroups, int kUnits, typename RowOf, typename Emit>
__device__ __forceinline__ void score_rows(const float* __restrict__ q, int nrows,
                                           int units, int lg, int vec, int warp,
                                           int nwarps, int lane, RowOf row_of,
                                           Emit emit) {
  if (vec)
    score_rows_as<T, true, kGroups, kUnits>(q, nrows, units, lg, warp, nwarps,
                                            lane, row_of, emit);
  else
    score_rows_as<T, false, kGroups, kUnits>(q, nrows, units, lg, warp, nwarps,
                                             lane, row_of, emit);
}

}  // namespace block_rows
