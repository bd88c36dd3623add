// The per-query top-k merge that both flat_topk kernels run beside their
// accumulators (csrc/flat_topk.cu, csrc/flat_topk_mma.cu): a query's buffer
// holds its top-k in [0, k) and the candidates that beat its threshold
// after; one warp sorts the occupied prefix when the candidate region would
// overflow, and at the end.
//
// Included by those sources only; `_build.py` hashes this header with each
// source, so a change here rebuilds both.

#pragma once

#include <math_constants.h>

// (distance, id) order: ties go to the smaller id, as in lax.top_k.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// One warp sorts the occupied prefix of a query's buffer, (top-k, then
// `n_cand` candidates), ascending by (distance, id); keeps the first k;
// clears the rest to (+inf, -1). Returns the new threshold, the k-th best
// distance. Slots past the occupied prefix already hold (+inf, -1).
// Up to 64 entries (k <= 48) sort in registers, two per lane, with warp
// shuffles; larger buffers sort in shared memory.
__device__ float warp_merge(float* bd, int* bi, int k, int n_cand, int lane) {
  const int m = k + n_cand;
  int p = 1;
  while (p < m) p <<= 1;
  if (p <= 64) {
    float d0 = bd[lane], d1 = p > 32 ? bd[lane + 32] : CUDART_INF_F;
    int i0 = bi[lane], i1 = p > 32 ? bi[lane + 32] : -1;
    for (int size = 2; size <= 64; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (stride == 32) {  // partners in the same lane
          if (before(d1, i1, d0, i0)) {
            const float td = d0; d0 = d1; d1 = td;
            const int ti = i0; i0 = i1; i1 = ti;
          }
          continue;
        }
        const float o0 = __shfl_xor_sync(0xffffffffu, d0, stride);
        const int j0 = __shfl_xor_sync(0xffffffffu, i0, stride);
        const float o1 = __shfl_xor_sync(0xffffffffu, d1, stride);
        const int j1 = __shfl_xor_sync(0xffffffffu, i1, stride);
        // element e keeps the smaller of (e, e ^ stride) when e is the lower
        // index of an ascending pair or the upper of a descending one
        const bool lower = (lane & stride) == 0;
        const bool keep0 = lower == ((lane & size) == 0);
        const bool keep1 = lower == (((lane + 32) & size) == 0);
        if (keep0 == before(o0, j0, d0, i0)) { d0 = o0; i0 = j0; }
        if (keep1 == before(o1, j1, d1, i1)) { d1 = o1; i1 = j1; }
      }
    }
    bd[lane] = lane < k ? d0 : CUDART_INF_F;
    bi[lane] = lane < k ? i0 : -1;
    if (p > 32) {
      bd[lane + 32] = lane + 32 < k ? d1 : CUDART_INF_F;
      bi[lane + 32] = lane + 32 < k ? i1 : -1;
    }
    const float t = __shfl_sync(0xffffffffu, k > 32 ? d1 : d0, (k - 1) & 31);
    __syncwarp();
    return t;
  }
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const float dl = bd[lo], dh = bd[hi];
        const int il = bi[lo], ih = bi[hi];
        const bool up = (lo & size) == 0;
        if (up ? before(dh, ih, dl, il) : before(dl, il, dh, ih)) {
          bd[lo] = dh; bd[hi] = dl;
          bi[lo] = ih; bi[hi] = il;
        }
      }
      __syncwarp();
    }
  }
  for (int t = k + lane; t < p; t += 32) {
    bd[t] = CUDART_INF_F;
    bi[t] = -1;
  }
  __syncwarp();
  return bd[k - 1];
}
