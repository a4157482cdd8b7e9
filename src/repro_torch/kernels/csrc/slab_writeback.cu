// Hand-written Hopper (sm_90a) kernel of the federated slab store.
//
//   slab_writeback — scatter a (u, d) chunk slab into the (n, d) client
//                    store, in place, at sorted unique row ids; a row id
//                    outside [0, n) (the sentinel n) is dropped; set or
//                    read-add-write
//                    (replaces repro/kernels/slab_writeback.py:
//                    slab_writeback_pallas)
//
// Pure data movement, bound by device-memory bytes (see slab_writeback.py
// for the numbers).  Grid: (slab row, column tile); a block reads its row
// id once, skips a sentinel row at once, and walks its columns with
// 16-byte (float4), 8-byte (float2) or 4-byte accesses, whichever the row
// strides and base pointers allow.  Row offsets are size_t: the store can
// hold more than 2^31 elements.  The ids are unique, so accumulate is a
// plain read-add-write with no atomics, and each element is written by
// one thread.  Plain C interface for ctypes: pointers and the stream come
// in as void*, the entry launches on the caller's stream, never
// synchronizes, allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// column tiles per row, at most: enough blocks for every SM even when
// the slab has only a few rows
constexpr int kMaxTiles = 64;
constexpr long long kTargetBlocks = 132LL * 16;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float2 add_rn(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// full: (n, d) with row stride full_stride (elements); rows: (u, d) with
// row stride rows_stride; idx: (u,) int32.  V divides d and both strides,
// and both base pointers are V*4-byte aligned.
template <int V, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
slab_writeback_kernel(float* __restrict__ full, const int* __restrict__ idx,
                      const float* __restrict__ rows, long long n,
                      long long d, long long full_stride,
                      long long rows_stride) {
  using T = typename Vec<V>::T;
  const long long j = blockIdx.x;
  const long long i = static_cast<long long>(__ldg(idx + j));
  if (i < 0 || i >= n) return;                      // the sentinel
  T* dst = reinterpret_cast<T*>(full + static_cast<size_t>(i) *
                                           static_cast<size_t>(full_stride));
  const T* src = reinterpret_cast<const T*>(
      rows + static_cast<size_t>(j) * static_cast<size_t>(rows_stride));
  const long long dv = d / V;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.y) * blockDim.x +
                     threadIdx.x;
       c < dv; c += step) {
    const T v = src[c];
    if (kAccumulate) {
      dst[c] = add_rn(dst[c], v);
    } else {
      dst[c] = v;
    }
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <int V>
void launch(float* full, const int* idx, const float* rows, long long n,
            long long d, long long u, long long full_stride,
            long long rows_stride, bool accumulate, cudaStream_t st) {
  const long long dv = d / V;
  long long tiles = (kTargetBlocks + u - 1) / u;
  const long long need = (dv + kThreads - 1) / kThreads;
  if (tiles > need) tiles = need;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  if (tiles < 1) tiles = 1;
  const dim3 grid(static_cast<unsigned>(u), static_cast<unsigned>(tiles));
  if (accumulate) {
    slab_writeback_kernel<V, true><<<grid, kThreads, 0, st>>>(
        full, idx, rows, n, d, full_stride, rows_stride);
  } else {
    slab_writeback_kernel<V, false><<<grid, kThreads, 0, st>>>(
        full, idx, rows, n, d, full_stride, rows_stride);
  }
}

}  // namespace

extern "C" {

// the widest access (4, 2 or 1 floats) that d, the strides and the base
// pointers allow
int slab_writeback_vec_width(const void* full, const void* rows, long long d,
                             long long full_stride, long long rows_stride) {
  if (d % 4 == 0 && full_stride % 4 == 0 && rows_stride % 4 == 0 &&
      aligned(full, 16) && aligned(rows, 16))
    return 4;
  if (d % 2 == 0 && full_stride % 2 == 0 && rows_stride % 2 == 0 &&
      aligned(full, 8) && aligned(rows, 8))
    return 2;
  return 1;
}

// full[idx[j], :] <- rows[j, :] (or += with accumulate) for every j whose
// idx[j] lies in [0, n); u <= 2^31 - 1 slab rows
int slab_writeback(void* full, const void* idx, const void* rows,
                   long long n, long long d, long long u,
                   long long full_stride, long long rows_stride,
                   int accumulate, void* stream) {
  if (u <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(full);
  const int* ix = static_cast<const int*>(idx);
  const float* r = static_cast<const float*>(rows);
  switch (slab_writeback_vec_width(full, rows, d, full_stride, rows_stride)) {
    case 4:
      launch<4>(f, ix, r, n, d, u, full_stride, rows_stride, accumulate != 0,
                st);
      break;
    case 2:
      launch<2>(f, ix, r, n, d, u, full_stride, rows_stride, accumulate != 0,
                st);
      break;
    default:
      launch<1>(f, ix, r, n, d, u, full_stride, rows_stride, accumulate != 0,
                st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
