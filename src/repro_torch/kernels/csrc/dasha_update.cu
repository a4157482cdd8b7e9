// Hand-written Hopper (sm_90a) kernels of the DASHA round.
//
//   dasha_update     — the fused estimator update, one elementwise pass
//                      (replaces repro/kernels/dasha_update.py:dasha_update_pallas)
//   dasha_mvr_update — the same pass with the MVR h-update fused in
//                      (replaces repro/kernels/dasha_update.py:
//                      dasha_mvr_update_pallas)
//   quantize_rows    — row-wise QSGD with external uniforms, two passes
//                      (replaces repro/kernels/dasha_update.py:quantize_pallas)
//
// All are bound by device-memory bytes (see dasha_update.py for the
// numbers).  Plain C interface for ctypes: pointers and the stream come in
// as void*, each entry launches on the caller's stream, never synchronizes,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// elements of one row that one quantize block covers
constexpr int kQuantChunk = 8192;

int sm_count() {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// enough blocks to fill every SM, no more than the work needs
int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// delta = grad - h - a * (g_local - h); m = mask * delta * scale;
// g_new = g_local + m.  Every op is rounded on its own, in the plain
// version's order: no FMA contraction, so the kernel matches the torch ops
// bit for bit.
__device__ __forceinline__ void dasha_one(float g, float h, float gl,
                                          float mk, float a, float scale,
                                          float* m, float* gn) {
  const float delta =
      __fsub_rn(__fsub_rn(g, h), __fmul_rn(a, __fsub_rn(gl, h)));
  const float mm = __fmul_rn(__fmul_rn(mk, delta), scale);
  *m = mm;
  *gn = __fadd_rn(gl, mm);
}

__global__ void __launch_bounds__(kThreads)
dasha_update_vec4(const float4* __restrict__ grad,
                  const float4* __restrict__ h,
                  const float4* __restrict__ gl,
                  const float4* __restrict__ mask,
                  float4* __restrict__ m, float4* __restrict__ h_out,
                  float4* __restrict__ gl_out, float a, float scale,
                  long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 g = grad[i];
    const float4 hh = h[i];
    const float4 l = gl[i];
    const float4 k = mask[i];
    float4 mo, go;
    dasha_one(g.x, hh.x, l.x, k.x, a, scale, &mo.x, &go.x);
    dasha_one(g.y, hh.y, l.y, k.y, a, scale, &mo.y, &go.y);
    dasha_one(g.z, hh.z, l.z, k.z, a, scale, &mo.z, &go.z);
    dasha_one(g.w, hh.w, l.w, k.w, a, scale, &mo.w, &go.w);
    m[i] = mo;
    h_out[i] = g;
    gl_out[i] = go;
  }
}

// elements [start, n): the tail after the float4 body, or everything when
// a pointer is not 16-byte aligned
__global__ void __launch_bounds__(kThreads)
dasha_update_scalar(const float* __restrict__ grad,
                    const float* __restrict__ h,
                    const float* __restrict__ gl,
                    const float* __restrict__ mask, float* __restrict__ m,
                    float* __restrict__ h_out, float* __restrict__ gl_out,
                    float a, float scale, long long start, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = start + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float g = grad[i];
    float mo, go;
    dasha_one(g, h[i], gl[i], mask[i], a, scale, &mo, &go);
    m[i] = mo;
    h_out[i] = g;
    gl_out[i] = go;
  }
}

// t = h - go; h_new = gn + c * t (c = 1 - b, rounded to fp32 by the caller
// exactly as the plain version rounds it); then dasha_one on h_new.  Every
// op rounded on its own, in the plain version's order.
__device__ __forceinline__ void mvr_one(float gn, float go, float h,
                                        float gl, float mk, float a,
                                        float c, float scale, float* hn,
                                        float* m, float* gout) {
  const float hnew = __fadd_rn(gn, __fmul_rn(c, __fsub_rn(h, go)));
  *hn = hnew;
  dasha_one(hnew, h, gl, mk, a, scale, m, gout);
}

__global__ void __launch_bounds__(kThreads)
dasha_mvr_update_vec4(const float4* __restrict__ gn,
                      const float4* __restrict__ go,
                      const float4* __restrict__ h,
                      const float4* __restrict__ gl,
                      const float4* __restrict__ mask,
                      float4* __restrict__ m, float4* __restrict__ h_out,
                      float4* __restrict__ gl_out, float a, float c,
                      float scale, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    const float4 n = gn[i];
    const float4 o = go[i];
    const float4 hh = h[i];
    const float4 l = gl[i];
    const float4 k = mask[i];
    float4 ho, mo, go4;
    mvr_one(n.x, o.x, hh.x, l.x, k.x, a, c, scale, &ho.x, &mo.x, &go4.x);
    mvr_one(n.y, o.y, hh.y, l.y, k.y, a, c, scale, &ho.y, &mo.y, &go4.y);
    mvr_one(n.z, o.z, hh.z, l.z, k.z, a, c, scale, &ho.z, &mo.z, &go4.z);
    mvr_one(n.w, o.w, hh.w, l.w, k.w, a, c, scale, &ho.w, &mo.w, &go4.w);
    m[i] = mo;
    h_out[i] = ho;
    gl_out[i] = go4;
  }
}

// elements [start, n): the tail after the float4 body, or everything when
// a pointer is not 16-byte aligned
__global__ void __launch_bounds__(kThreads)
dasha_mvr_update_scalar(const float* __restrict__ gn,
                        const float* __restrict__ go,
                        const float* __restrict__ h,
                        const float* __restrict__ gl,
                        const float* __restrict__ mask,
                        float* __restrict__ m, float* __restrict__ h_out,
                        float* __restrict__ gl_out, float a, float c,
                        float scale, long long start, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = start + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float ho, mo, go1;
    mvr_one(gn[i], go[i], h[i], gl[i], mask[i], a, c, scale, &ho, &mo, &go1);
    m[i] = mo;
    h_out[i] = ho;
    gl_out[i] = go1;
  }
}

// Sum over the block in a fixed order (shuffle tree, then warps in index
// order), so every block that sums the same values gets the same bits.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
    total = s;
  }
  __syncthreads();
  return total;
}

// pass 1: partials[row, chunk] = sum of x^2 over the chunk
__global__ void __launch_bounds__(kThreads)
quantize_partials(const float* __restrict__ x, float* __restrict__ partials,
                  long long cols, int chunks) {
  const long long row = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kQuantChunk;
  const long long hi = lo + kQuantChunk < cols ? lo + kQuantChunk : cols;
  const float* xr = x + row * cols;
  float acc = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float v = xr[i];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[row * chunks + blockIdx.x] = s;
}

// pass 2: each block sums its row's partials in a fixed order (no atomics:
// repeated runs give the same bits), then quantizes its chunk
__global__ void __launch_bounds__(kThreads)
quantize_apply(const float* __restrict__ x, const float* __restrict__ u,
               const float* __restrict__ partials, float* __restrict__ out,
               long long cols, int chunks, float s) {
  const long long row = blockIdx.y;
  float acc = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    acc = __fadd_rn(acc, partials[row * chunks + c]);
  }
  const float norm = __fsqrt_rn(block_sum(acc));
  const float safe = norm > 0.f ? norm : 1.f;
  const long long lo = static_cast<long long>(blockIdx.x) * kQuantChunk;
  const long long hi = lo + kQuantChunk < cols ? lo + kQuantChunk : cols;
  const float* xr = x + row * cols;
  const float* ur = u + row * cols;
  float* outr = out + row * cols;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float xv = xr[i];
    const float y = __fmul_rn(__fdiv_rn(fabsf(xv), safe), s);
    const float fl = floorf(y);
    const float q = __fadd_rn(fl, ur[i] < __fsub_rn(y, fl) ? 1.f : 0.f);
    const float sgn = xv > 0.f ? 1.f : (xv < 0.f ? -1.f : 0.f);
    const float v = __fdiv_rn(__fmul_rn(__fmul_rn(sgn, q), safe), s);
    outr[i] = norm > 0.f ? v : 0.f;
  }
}

}  // namespace

extern "C" {

// (m, h_out, g_out) <- fused update of n fp32 elements
int dasha_update(const void* grad, const void* h, const void* g_local,
                 const void* mask, void* m, void* h_out, void* g_out,
                 float a, float scale, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(grad) && aligned16(h) && aligned16(g_local) &&
                   aligned16(mask) && aligned16(m) && aligned16(h_out) &&
                   aligned16(g_out);
  const long long n4 = vec ? n / 4 : 0;
  if (n4 > 0) {
    dasha_update_vec4<<<grid_for(n4), kThreads, 0, st>>>(
        static_cast<const float4*>(grad), static_cast<const float4*>(h),
        static_cast<const float4*>(g_local), static_cast<const float4*>(mask),
        static_cast<float4*>(m), static_cast<float4*>(h_out),
        static_cast<float4*>(g_out), a, scale, n4);
  }
  const long long start = n4 * 4;
  if (start < n) {
    dasha_update_scalar<<<grid_for(n - start), kThreads, 0, st>>>(
        static_cast<const float*>(grad), static_cast<const float*>(h),
        static_cast<const float*>(g_local), static_cast<const float*>(mask),
        static_cast<float*>(m), static_cast<float*>(h_out),
        static_cast<float*>(g_out), a, scale, start, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// (m, h_out, g_out) <- fused MVR update of n fp32 elements; c = 1 - b
int dasha_mvr_update(const void* gn, const void* go, const void* h,
                     const void* g_local, const void* mask, void* m,
                     void* h_out, void* g_out, float a, float c, float scale,
                     long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(gn) && aligned16(go) && aligned16(h) &&
                   aligned16(g_local) && aligned16(mask) && aligned16(m) &&
                   aligned16(h_out) && aligned16(g_out);
  const long long n4 = vec ? n / 4 : 0;
  if (n4 > 0) {
    dasha_mvr_update_vec4<<<grid_for(n4), kThreads, 0, st>>>(
        static_cast<const float4*>(gn), static_cast<const float4*>(go),
        static_cast<const float4*>(h), static_cast<const float4*>(g_local),
        static_cast<const float4*>(mask), static_cast<float4*>(m),
        static_cast<float4*>(h_out), static_cast<float4*>(g_out), a, c, scale,
        n4);
  }
  const long long start = n4 * 4;
  if (start < n) {
    dasha_mvr_update_scalar<<<grid_for(n - start), kThreads, 0, st>>>(
        static_cast<const float*>(gn), static_cast<const float*>(go),
        static_cast<const float*>(h), static_cast<const float*>(g_local),
        static_cast<const float*>(mask), static_cast<float*>(m),
        static_cast<float*>(h_out), static_cast<float*>(g_out), a, c, scale,
        start, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// elements of one row per quantize block: the wrapper sizes the
// (rows, ceil(cols / chunk)) partial-sum scratch with it
int quantize_chunk_elems() { return kQuantChunk; }

// out <- row-wise QSGD of the (rows, cols) fp32 matrix x with uniforms u;
// partials is (rows, ceil(cols / chunk)) fp32 scratch
int quantize_rows(const void* x, const void* u, void* out, void* partials,
                  long long rows, long long cols, float levels,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const long long chunks = (cols + kQuantChunk - 1) / kQuantChunk;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(rows));
  quantize_partials<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(partials), cols,
      static_cast<int>(chunks));
  quantize_apply<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(partials), static_cast<float*>(out), cols,
      static_cast<int>(chunks), levels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
