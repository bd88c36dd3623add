// Row gather: out[i] = table[idx[i]] for an [N, row] table of any element
// type, bit for bit.
//
// Replaces: muninn_tpu/ops/pallas_gather.py `_gather_kernel`
// (pallas_gather.py:36-59), launched through `gather_rows` (:62-94,
// pallas_call at :79): a pipelined per-row DMA of tile-padded rows, M a
// multiple of its row block. Here any M and any row width: no padding.
//
// Contract: idx [M] int32; a row of idx in [0, N) is copied; an index
// outside [0, N) is a caller's fault: it reads nothing and fills its output
// row with 0xFF bytes (NaN for f32 and bf16, -1 for int8), so the fault
// shows in the results instead of reading past the table, as beam_dots
// writes NaN for a pick past its table.
//
// What bounds it on an H100: device-memory bytes, M * row bytes read and
// written (plus 4 B of index per row) and no arithmetic. What the design does
// about it: as many bytes in flight as the card holds. The output is one
// flat stream of M * units units (16 bytes where the table, the output and
// the row width are 16-byte aligned, else one element); thread e moves unit
// e % units of row e / units, neighbouring threads on neighbouring
// addresses, and starts the loads of four units a grid apart before any of
// their stores. So every SM keeps thousands of independent loads in flight
// whatever the row width, and rows never wait on one another (a warp per
// row moved a 1,536-byte row as 3 loads a lane, one after another's store).
//
// Interface: plain C functions, loaded with ctypes. The launcher runs on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // units a thread loads before it stores

__device__ __forceinline__ void all_ones(uint4& u) { u = make_uint4(~0u, ~0u, ~0u, ~0u); }
__device__ __forceinline__ void all_ones(uint32_t& u) { u = ~0u; }
__device__ __forceinline__ void all_ones(uint16_t& u) { u = 0xffffu; }
__device__ __forceinline__ void all_ones(uint8_t& u) { u = 0xffu; }

// U is the unit a thread moves: uint4 (16 bytes) or the element's own width.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const U* __restrict__ table, const int* __restrict__ idx,
                   U* __restrict__ out, long long M, int N, int units) {
  const long long total = M * units;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e0 = (long long)blockIdx.x * kThreads + threadIdx.x; e0 < total;
       e0 += kInFlight * stride) {
    U v[kInFlight];
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) {
      const long long e = e0 + t * stride;
      if (e >= total) continue;
      const long long row = e / units;
      const int u = (int)(e - row * units);
      const int id = __ldg(idx + row);
      if (id >= 0 && id < N) v[t] = __ldg(table + (size_t)id * units + u);
      else all_ones(v[t]);
    }
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) {
      const long long e = e0 + t * stride;
      if (e < total) out[e] = v[t];
    }
  }
}

template <typename U>
cudaError_t launch(const void* table, const int* idx, void* out, long long M,
                   int N, int units, cudaStream_t stream) {
  const long long blocks = (M * units + kInFlight * kThreads - 1) / (kInFlight * kThreads);
  const int grid = (int)(blocks < 65535LL * 64 ? blocks : 65535LL * 64);
  gather_rows_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), M, N, units);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gather_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table [N, D] of `itemsize`-byte elements (1, 2 or 4), idx [M] int32,
// out [M, D] of the table's type; all contiguous, on card `device`.
int gather_rows(const void* table, const void* idx, void* out, long long M,
                int N, int D, int itemsize, int device, void* stream) {
  if (M < 1 || N < 0 || D < 1 ||
      (itemsize != 1 && itemsize != 2 && itemsize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current card is its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = (size_t)D * itemsize;
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return static_cast<int>(
        launch<uint4>(table, ix, out, M, N, (int)(row_bytes / 16), st));
  switch (itemsize) {
    case 4: return static_cast<int>(launch<uint32_t>(table, ix, out, M, N, D, st));
    case 2: return static_cast<int>(launch<uint16_t>(table, ix, out, M, N, D, st));
    default: return static_cast<int>(launch<uint8_t>(table, ix, out, M, N, D, st));
  }
}

}  // extern "C"
