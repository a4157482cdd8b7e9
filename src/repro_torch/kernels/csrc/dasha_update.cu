// Hand-written Hopper (sm_90a) kernels of the DASHA round.
//
//   dasha_update     — the fused estimator update on a dense fp32 mask, with
//                      h_new written as a copy of grad (replaces repro/
//                      kernels/dasha_update.py:dasha_update_pallas)
//   dasha_sparsify_update — the same update for the sparsifiers (RandK,
//                      PermK, Bernoulli) and passthrough, with the support
//                      built in the launch from the plan's indices or read
//                      from its mask (the reference runs the mask build as
//                      jnp ops around dasha_update_pallas); both entries
//                      launch one rows kernel
//   dasha_mvr_update — the same pass with the MVR h-update fused in, by
//                      rows, on an fp32 or byte mask (replaces repro/
//                      kernels/dasha_update.py:dasha_mvr_update_pallas)
//   quantize_rows    — row-wise QSGD with external uniforms
//                      (replaces repro/kernels/dasha_update.py:
//                      quantize_pallas)
//   dasha_quantize_update — the QDither estimator update: the drift, QSGD
//                      and g_local += m in one launch (the reference runs
//                      it as jnp ops around quantize_pallas)
//
// A sweep's G lanes may give a (and kernel 3's c = 1 - b) one value a lane:
// a (G,) fp32 array read once a block at a_t[row / a_div], where a_div is
// the rows of one lane; a null array keeps the scalar.
//
// All are bound by device-memory bytes (see dasha_update.py for the
// numbers).  Plain C interface for ctypes: pointers and the stream come in
// as void*, each entry launches on the caller's stream, never synchronizes,
// allocates nothing and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// the largest cluster a row may take (16 is non-portable: quantize_init
// asks the card whether it takes it)
constexpr int kMaxCluster = 16;

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

// ---------------------------------------------------------------------------
// Kernel 2: row-wise QSGD, plain (x) or fused (x = the drift of h_new, h,
// g_local).  Every sum of squares runs in a fixed order: each thread over
// its own elements in index order, a shuffle tree in the warp, the warps in
// index order, then the blocks of the row in index order.  Every block of
// a row thus gets the same norm bits and repeated runs are bit-identical.

struct QArgs {
  const float* x;        // plain: x; fused: h_new
  const float* h;        // fused only
  const float* gl;       // fused only: g_local
  const float* u;        // (u_rows, cols) uniforms, row r read at r % u_rows
  const float* scale_t;  // fused: per-row scale (scale_rows), or null
  const float* a_t;      // fused: per-lane a, read at row / a_div, or null
  float* out;            // plain: out; fused: m
  float* g_out;          // fused only: g_local + m
  float* partials;       // two-pass only: (rows, blocks_per_row)
  long long cols;
  long long u_rows;
  long long scale_rows;
  long long a_div;       // rows of one lane (a_t)
  long long per_block;   // vectors of a row one block covers
  long long blocks_per_row;
  float a, scale, levels;
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&o)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    *p = o[0];
  }
}

// x of V elements at element offset e of the row: x itself, or the drift
// (h_new - h) - a (g_local - h) with g_local kept for the epilogue, each op
// rounded once in the plain version's order
template <int V, bool FUSED>
__device__ __forceinline__ void load_x(const QArgs& p, long long e, float a,
                                       float (&x)[V], float (&g)[V]) {
  if constexpr (FUSED) {
    float hn[V], hh[V];
    load_vec<V>(p.x + e, hn);
    load_vec<V>(p.h + e, hh);
    load_vec<V>(p.gl + e, g);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      x[c] = __fsub_rn(__fsub_rn(hn[c], hh[c]),
                       __fmul_rn(a, __fsub_rn(g[c], hh[c])));
    }
  } else {
    load_vec<V>(p.x + e, x);
  }
}

// the fused entry's a for a row: the lane's (a_t[row / a_div]) or the
// scalar
__device__ __forceinline__ float quant_a(const QArgs& p, long long row) {
  return p.a_t != nullptr ? p.a_t[row / p.a_div] : p.a;
}

// one QSGD element: the plain version's ops, each rounded once
__device__ __forceinline__ float qsgd_one(float xv, float uv, float safe,
                                          float s, bool nonzero) {
  const float y = __fmul_rn(__fdiv_rn(fabsf(xv), safe), s);
  const float fl = floorf(y);
  const float q = __fadd_rn(fl, uv < __fsub_rn(y, fl) ? 1.f : 0.f);
  const float sgn = xv > 0.f ? 1.f : (xv < 0.f ? -1.f : 0.f);
  const float v = __fdiv_rn(__fmul_rn(__fmul_rn(sgn, q), safe), s);
  return nonzero ? v : 0.f;
}

// quantize V elements and store them: out, or (fused) m = out * scale and
// g_out = g_local + m, each rounded once in that order
template <int V, bool FUSED>
__device__ __forceinline__ void emit(const QArgs& p, long long e,
                                     const float (&x)[V], const float (&u)[V],
                                     const float (&g)[V], float safe,
                                     bool nonzero, float sc) {
  float q[V];
#pragma unroll
  for (int c = 0; c < V; ++c) q[c] = qsgd_one(x[c], u[c], safe, p.levels,
                                              nonzero);
  if constexpr (FUSED) {
    float gn[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      q[c] = __fmul_rn(q[c], sc);
      gn[c] = __fadd_rn(g[c], q[c]);
    }
    store_vec<V>(p.g_out + e, gn);
  }
  store_vec<V>(p.out + e, q);
}

// The block's sum in a fixed order (shuffle tree, then warps in index
// order); the total is valid in thread 0 only.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      s = __fadd_rn(s, warp_sums[w]);
    }
  }
  return s;
}

// The cluster barrier split in two: arrive early, wait where needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Cluster path: one cluster of blocks_per_row blocks a row.  Block `rank`
// holds vectors [rank * per_block, (rank + 1) * per_block) of its row in
// registers (VPT vectors of V floats a thread, coalesced) and sums their
// squares.  Lanes of warp 0 then push the block's partial into slot `rank`
// of every block's shared memory (distributed shared memory), once a first
// barrier phase, begun before the loads, shows every peer running; after
// a second each block holds all partials locally and every thread sums
// them in rank order.  No block touches a peer's shared memory after that,
// so none has to wait for its peers before it exits.  x is read once: 12
// bytes an element (plain), 24 (fused).
template <int V, int VPT, bool FUSED>
__device__ __forceinline__ void cluster_body(const QArgs& p) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float parts[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cl = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long row = blockIdx.x / cl;
  const long long nvec = p.cols / V;
  const long long lo = rank * p.per_block;
  const long long hi = lo + p.per_block < nvec ? lo + p.per_block : nvec;
  const long long cnt = hi > lo ? hi - lo : 0;
  const long long base = row * p.cols + lo * V;
  const long long ubase = (row % p.u_rows) * p.cols + lo * V;
  const float sc = FUSED && p.scale_t != nullptr
                       ? p.scale_t[row % p.scale_rows] : p.scale;
  const float a = FUSED ? quant_a(p, row) : 0.f;
  if (cl > 1) cluster_arrive_relaxed();     // this block runs

  float x[VPT][V], u[VPT][V], g[FUSED ? VPT : 1][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long k = static_cast<long long>(j) * blockDim.x + threadIdx.x;
    if (k < cnt) {
      load_x<V, FUSED>(p, base + k * V, a, x[j], g[FUSED ? j : 0]);
      load_vec<V>(p.u + ubase + k * V, u[j]);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long k = static_cast<long long>(j) * blockDim.x + threadIdx.x;
    if (k < cnt) {
#pragma unroll
      for (int c = 0; c < V; ++c) acc = __fadd_rn(acc, __fmul_rn(x[j][c],
                                                                 x[j][c]));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (cl > 1) cluster_wait();               // every peer runs
  if (threadIdx.x < 32) {
    float s = 0.f;
    if (threadIdx.x == 0) {
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
        s = __fadd_rn(s, warp_sums[w]);
      }
    }
    s = __shfl_sync(0xffffffffu, s, 0);
    if (threadIdx.x < cl) {
      *cluster.map_shared_rank(&parts[rank], threadIdx.x) = s;
    }
  }
  if (cl > 1) {
    cluster.sync();                     // every block's partial has landed
  } else {
    __syncthreads();
  }
  float tot = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < static_cast<int>(cl)) tot = __fadd_rn(tot, parts[r]);
  }
  const float norm = __fsqrt_rn(tot);
  const bool nonzero = norm > 0.f;
  const float safe = nonzero ? norm : 1.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long long k = static_cast<long long>(j) * blockDim.x + threadIdx.x;
    if (k < cnt) {
      emit<V, FUSED>(p, base + k * V, x[j], u[j], g[FUSED ? j : 0], safe,
                     nonzero, sc);
    }
  }
}

template <int V, int VPT>
__global__ void __launch_bounds__(kThreads) quantize_cluster(QArgs p) {
  cluster_body<V, VPT, false>(p);
}

template <int V, int VPT>
__global__ void __launch_bounds__(kThreads) dasha_quantize_cluster(QArgs p) {
  cluster_body<V, VPT, true>(p);
}

// Two-pass path, for rows wider than a cluster holds: pass 1 writes each
// (row, chunk)'s sum of squares, pass 2 sums its row's partials in a fixed
// order (no atomics) and quantizes its chunk, recomputing the drift when
// fused.  x is read twice: 16 bytes an element (plain).  Pass 2 walks the
// chunks in reverse so that its first blocks find pass 1's last in L2.
template <int V, bool FUSED>
__device__ __forceinline__ void partials_body(const QArgs& p) {
  const long long row = blockIdx.x / p.blocks_per_row;
  const long long chunk = blockIdx.x % p.blocks_per_row;
  const long long nvec = p.cols / V;
  const long long lo = chunk * p.per_block;
  const long long hi = lo + p.per_block < nvec ? lo + p.per_block : nvec;
  const long long base = row * p.cols;
  const float a = FUSED ? quant_a(p, row) : 0.f;
  float acc = 0.f;
#pragma unroll 4
  for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    float x[V], g[V];
    load_x<V, FUSED>(p, base + k * V, a, x, g);
#pragma unroll
    for (int c = 0; c < V; ++c) acc = __fadd_rn(acc, __fmul_rn(x[c], x[c]));
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) p.partials[blockIdx.x] = s;
}

template <int V, bool FUSED>
__device__ __forceinline__ void apply_body(const QArgs& p) {
  __shared__ float norm_s;
  const long long b = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const long long row = b / p.blocks_per_row;
  const long long chunk = b % p.blocks_per_row;
  const float* part = p.partials + row * p.blocks_per_row;
  float acc = 0.f;
  for (long long c = threadIdx.x; c < p.blocks_per_row; c += blockDim.x) {
    acc = __fadd_rn(acc, part[c]);
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) norm_s = __fsqrt_rn(s);
  __syncthreads();
  const float norm = norm_s;
  const bool nonzero = norm > 0.f;
  const float safe = nonzero ? norm : 1.f;
  const float sc = FUSED && p.scale_t != nullptr
                       ? p.scale_t[row % p.scale_rows] : p.scale;
  const long long nvec = p.cols / V;
  const long long lo = chunk * p.per_block;
  const long long hi = lo + p.per_block < nvec ? lo + p.per_block : nvec;
  const long long base = row * p.cols;
  const long long ubase = (row % p.u_rows) * p.cols;
  const float a = FUSED ? quant_a(p, row) : 0.f;
#pragma unroll 4
  for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    float x[V], g[V], u[V];
    load_x<V, FUSED>(p, base + k * V, a, x, g);
    load_vec<V>(p.u + ubase + k * V, u);
    emit<V, FUSED>(p, base + k * V, x, u, g, safe, nonzero, sc);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) quantize_partials(QArgs p) {
  partials_body<V, false>(p);
}

template <int V>
__global__ void __launch_bounds__(kThreads) quantize_apply(QArgs p) {
  apply_body<V, false>(p);
}

template <int V>
__global__ void __launch_bounds__(kThreads) dasha_quantize_partials(QArgs p) {
  partials_body<V, true>(p);
}

template <int V>
__global__ void __launch_bounds__(kThreads) dasha_quantize_apply(QArgs p) {
  apply_body<V, true>(p);
}

using QKernel = void (*)(QArgs);

template <int V, int VPT>
QKernel pick_cluster(bool fused) {
  return fused ? static_cast<QKernel>(&dasha_quantize_cluster<V, VPT>)
               : static_cast<QKernel>(&quantize_cluster<V, VPT>);
}

// the cluster kernel of (fused, V, VPT), or null for a plan this file
// does not instantiate (VPT a power of two, VPT <= 8)
template <int V>
QKernel cluster_kernel_v(bool fused, int vpt) {
  switch (vpt) {
    case 1: return pick_cluster<V, 1>(fused);
    case 2: return pick_cluster<V, 2>(fused);
    case 4: return pick_cluster<V, 4>(fused);
    case 8: return pick_cluster<V, 8>(fused);
    default: return nullptr;
  }
}

QKernel cluster_kernel(bool fused, int vec, int vpt) {
  switch (vec) {
    case 1: return cluster_kernel_v<1>(fused, vpt);
    case 2: return cluster_kernel_v<2>(fused, vpt);
    case 4: return cluster_kernel_v<4>(fused, vpt);
    default: return nullptr;
  }
}

template <int V>
void two_pass_kernels_v(bool fused, QKernel* k1, QKernel* k2) {
  *k1 = fused ? static_cast<QKernel>(&dasha_quantize_partials<V>)
              : static_cast<QKernel>(&quantize_partials<V>);
  *k2 = fused ? static_cast<QKernel>(&dasha_quantize_apply<V>)
              : static_cast<QKernel>(&quantize_apply<V>);
}

bool two_pass_kernels(bool fused, int vec, QKernel* k1, QKernel* k2) {
  switch (vec) {
    case 1: two_pass_kernels_v<1>(fused, k1, k2); return true;
    case 2: two_pass_kernels_v<2>(fused, k1, k2); return true;
    case 4: two_pass_kernels_v<4>(fused, k1, k2); return true;
    default: return false;
  }
}

// Launch one plan: the cluster path as one launch with a cluster of
// blocks_per_row blocks a row, or the two passes.  Refuses a plan whose
// numbers no kernel here takes, or whose grid the card would refuse.
int launch_quantize(bool fused, const QArgs& p, long long rows, int two_pass,
                    int vec, int vpt, int threads, cudaStream_t st) {
  if (rows <= 0 || p.cols <= 0) return static_cast<int>(cudaGetLastError());
  const long long grid = rows * p.blocks_per_row;
  if ((vec != 1 && vec != 2 && vec != 4) || threads < 32 ||
      threads > kThreads || threads % 32 != 0 ||
      p.blocks_per_row < 1 || p.per_block < 1 || grid > 0x7fffffffLL ||
      p.cols % vec != 0 || p.blocks_per_row * p.per_block < p.cols / vec ||
      (p.a_t != nullptr && (p.a_div < 1 || rows % p.a_div != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (two_pass) {
    QKernel k1 = nullptr, k2 = nullptr;
    if (!two_pass_kernels(fused, vec, &k1, &k2) || p.partials == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    k1<<<static_cast<unsigned>(grid), threads, 0, st>>>(p);
    k2<<<static_cast<unsigned>(grid), threads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const QKernel k = cluster_kernel(fused, vec, vpt);
  if (k == nullptr || p.blocks_per_row > kMaxCluster ||
      p.per_block > static_cast<long long>(vpt) * threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.blocks_per_row);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Kernels 1 and 3 by rows.  A (rows, cols) matrix in tiles of a row: block
// b covers `span` elements of row b / blocks_per_row.  Each thread holds
// vpt (1 to kMaxVpt) vectors of W floats of every operand: every load of a
// sub-tile is issued before any arithmetic, and the index form builds its
// bitmap while the first sub-tile's loads are in flight, so a short row
// costs about one memory round trip.  The support of row r is row
// r % s_rows of the support, the scale row r % sc_rows of scale_t: a lane
// axis and a shared support need no copy.

// the support of a row, as the kernel reads it
enum SupportForm { kDense = 0, kIndex = 1, kMaskF32 = 2, kMaskU8 = 3 };

// the most vectors of each operand a thread holds per sub-tile (the plan's
// vpt, 1 to 4)
constexpr int kMaxVpt = 4;

struct RArgs {
  const float* grad;     // kernel 1: h_new; kernel 3: grad_new
  const float* go;       // kernel 3: grad_old
  const float* h;
  const float* gl;       // g_local
  const void* support;   // (s_rows, k) int64 | (s_rows, cols) fp32 / uint8
  const float* scale_t;  // (sc_rows,) per-row scale, or null
  const float* a_t;      // (G,) per-lane a, read at row / ac_div, or null
  const float* c_t;      // kernel 3: (G,) per-lane c = 1 - b, or null
  float* m;
  float* h_out;          // kernel 3: h_new; dense-mask entry: a copy of grad
  float* g_out;
  long long rows, cols;
  long long s_rows, k, sc_rows;
  long long ac_div;          // rows of one lane (a_t, c_t)
  long long span;            // elements of a row a block covers (W | span)
  long long blocks_per_row;
  int vpt;                   // vectors of each operand a thread holds
  float a, c, scale;         // c = 1 - b (kernel 3)
};

template <int W>
__device__ __forceinline__ void load_u8(const unsigned char* p,
                                        float (&o)[W]) {
  if constexpr (W == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (W == 2) {
    const uchar2 t = *reinterpret_cast<const uchar2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

// one element: mk is the support value (1 or 0 from an index bitmap or a
// byte, the fp32 mask value, or 1 where there is no support); with a
// per-row scale the torch chain folded it into the mask (mask * scale,
// then a kernel scale of 1), and so does this, op for op.  Kernel 1's
// h_out is g itself.
template <bool MVR>
__device__ __forceinline__ void rows_one(const RArgs& p, float g, float o,
                                         float hh, float l, float mk,
                                         float row_scale, float a, float c,
                                         float* mo, float* ho, float* gout) {
  float scale = p.scale;
  if (p.scale_t != nullptr) {
    mk = __fmul_rn(mk, row_scale);
    scale = 1.0f;
  }
  if constexpr (MVR) {
    mvr_one(g, o, hh, l, mk, a, c, scale, ho, mo, gout);
  } else {
    *ho = g;
    dasha_one(g, hh, l, mk, a, scale, mo, gout);
  }
}

// the index form's bitmap of the block's elements [f0, f1) of row r: bit
// e for element f0 + e, from the row's k indices (index row r % s_rows;
// PAD and columns outside the tile dropped).  Each thread issues kScan
// index loads before its atomics.
constexpr int kScan = 8;

// r % m for a row index and a row count below 2^31 (launch_rows checks
// the rows): 32-bit, where a 64-bit remainder is a long software routine
// that would sit before a block's first load
__device__ __forceinline__ long long row_mod(long long r, long long m) {
  return static_cast<long long>(static_cast<unsigned>(r) %
                                static_cast<unsigned>(m));
}

// r / m, 32-bit as row_mod
__device__ __forceinline__ long long row_div(long long r, long long m) {
  return static_cast<long long>(static_cast<unsigned>(r) /
                                static_cast<unsigned>(m));
}

__device__ __forceinline__ void build_bitmap(const RArgs& p, long long r,
                                             long long f0, long long f1,
                                             unsigned* bits) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long len = f1 - f0;
  const int words = static_cast<int>((len + 31) >> 5);
  for (int i = tid; i < words; i += nt) bits[i] = 0u;
  __syncthreads();
  const long long* idx =
      static_cast<const long long*>(p.support) + row_mod(r, p.s_rows) * p.k;
  const long long base = r * p.cols - f0;
  for (long long j0 = 0; j0 < p.k; j0 += static_cast<long long>(nt) * kScan) {
    long long col[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const long long j = j0 + static_cast<long long>(q) * nt + tid;
      col[q] = j < p.k ? __ldg(idx + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (col[q] >= 0 && col[q] < p.cols) {
        const long long e = base + col[q];
        if (e >= 0 && e < len) {
          atomicOr(&bits[e >> 5], 1u << static_cast<unsigned>(e & 31));
        }
      }
    }
  }
  __syncthreads();
}

// H_OUT: write h_out (kernel 3's h_new, the dense-mask entry's copy of
// grad); the sparsifier entry returns grad itself and writes none
template <int W, int FORM, bool MVR, bool H_OUT>
__device__ __forceinline__ void rows_body(const RArgs& p) {
  extern __shared__ unsigned rows_bits[];  // the index form's bitmap
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int vpt = p.vpt;
  const unsigned bpr = static_cast<unsigned>(p.blocks_per_row);
  const unsigned row = blockIdx.x / bpr;
  const long long r = row;
  const long long c0 = static_cast<long long>(blockIdx.x - row * bpr) * p.span;
  const long long c1 = c0 + p.span < p.cols ? c0 + p.span : p.cols;
  const long long f0 = r * p.cols + c0;
  const long long f1 = r * p.cols + c1;
  const float rs =
      p.scale_t != nullptr ? p.scale_t[row_mod(r, p.sc_rows)] : 1.0f;
  // the lane's a and c, or the scalars
  const float a = p.a_t != nullptr ? p.a_t[row_div(r, p.ac_div)] : p.a;
  const float c = MVR && p.c_t != nullptr ? p.c_t[row_div(r, p.ac_div)]
                                          : p.c;
  // a mask row's element f of row r lies at f + so
  const long long so = (row_mod(r, p.s_rows) - r) * p.cols;
  // W divides cols and span, and c0 < cols (launch_rows checks both), so
  // the block has at least one vector and every thread of the block runs
  // the first pass, where the index form's bitmap and its barriers are
  const long long v0 = f0 / W;
  const long long v1 = f1 / W;
  const long long stride = static_cast<long long>(nt) * vpt;
  for (long long s = v0; s < v1; s += stride) {
    float g[kMaxVpt][W], hh[kMaxVpt][W], l[kMaxVpt][W], o[kMaxVpt][W],
        mk[kMaxVpt][W];
#pragma unroll
    for (int j = 0; j < kMaxVpt; ++j) {
      const long long v = s + static_cast<long long>(j) * nt + tid;
      if (j < vpt && v < v1) {
        const long long e = v * W;
        load_vec<W>(p.grad + e, g[j]);
        load_vec<W>(p.h + e, hh[j]);
        load_vec<W>(p.gl + e, l[j]);
        if constexpr (MVR) load_vec<W>(p.go + e, o[j]);
        if constexpr (FORM == kMaskF32) {
          load_vec<W>(static_cast<const float*>(p.support) + e + so, mk[j]);
        } else if constexpr (FORM == kMaskU8) {
          load_u8<W>(static_cast<const unsigned char*>(p.support) + e + so,
                     mk[j]);
        }
      }
    }
    if constexpr (FORM == kIndex) {
      // while the first sub-tile's loads are in flight
      if (s == v0) build_bitmap(p, r, f0, f1, rows_bits);
    }
#pragma unroll
    for (int j = 0; j < kMaxVpt; ++j) {
      const long long v = s + static_cast<long long>(j) * nt + tid;
      if (j < vpt && v < v1) {
        const long long e = v * W;
        unsigned word = 0u;
        if constexpr (FORM == kIndex) {
          const long long b = e - f0;
          word = rows_bits[b >> 5] >> static_cast<unsigned>(b & 31);
        }
        float mo[W], ho[W], go[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          float support = 1.0f;
          if constexpr (FORM == kIndex) {
            support = ((word >> i) & 1u) ? 1.0f : 0.0f;
          } else if constexpr (FORM == kMaskF32 || FORM == kMaskU8) {
            support = mk[j][i];
          }
          rows_one<MVR>(p, g[j][i], MVR ? o[j][i] : 0.0f, hh[j][i], l[j][i],
                        support, rs, a, c, &mo[i], &ho[i], &go[i]);
        }
        store_vec<W>(p.m + e, mo);
        store_vec<W>(p.g_out + e, go);
        if constexpr (H_OUT) store_vec<W>(p.h_out + e, ho);
      }
    }
  }
}

// kernel 1's sparsifier entry: m and g_new; h_new is the caller's grad
template <int W, int FORM>
__global__ void __launch_bounds__(kThreads) dasha_sparsify_rows(RArgs p) {
  rows_body<W, FORM, false, false>(p);
}

// kernel 1's dense-mask entry: m, g_new and h_new a copy of grad, on an
// fp32 mask
template <int W>
__global__ void __launch_bounds__(kThreads) dasha_update_rows(RArgs p) {
  rows_body<W, kMaskF32, false, true>(p);
}

// kernel 3: m, h_new and g_new, a mask of fp32 or bytes
template <int W, int FORM>
__global__ void __launch_bounds__(kThreads) dasha_mvr_update_rows(RArgs p) {
  rows_body<W, FORM, true, true>(p);
}

using RKernel = void (*)(RArgs);

// the entry a rows launch serves
enum RowsEntry { kSparsify = 0, kDenseMask = 1, kMvr = 2 };

template <int W>
RKernel rows_kernel_w(int entry, int form) {
  if (entry == kDenseMask) {
    return form == kMaskF32 ? &dasha_update_rows<W> : nullptr;
  }
  if (entry == kMvr) {
    if (form == kMaskF32) return &dasha_mvr_update_rows<W, kMaskF32>;
    if (form == kMaskU8) return &dasha_mvr_update_rows<W, kMaskU8>;
    return nullptr;
  }
  switch (form) {
    case kDense: return &dasha_sparsify_rows<W, kDense>;
    case kIndex: return &dasha_sparsify_rows<W, kIndex>;
    case kMaskF32: return &dasha_sparsify_rows<W, kMaskF32>;
    case kMaskU8: return &dasha_sparsify_rows<W, kMaskU8>;
    default: return nullptr;
  }
}

RKernel rows_kernel(int entry, int form, int vec) {
  switch (vec) {
    case 1: return rows_kernel_w<1>(entry, form);
    case 2: return rows_kernel_w<2>(entry, form);
    case 4: return rows_kernel_w<4>(entry, form);
    default: return nullptr;
  }
}

// Launch one plan of kernels 1 and 3 by rows.  Refuses a plan whose
// numbers no kernel here takes, or whose grid the card would refuse.
int launch_rows(int entry, const RArgs& p, int form, int vec, int threads,
                cudaStream_t st) {
  if (p.rows <= 0 || p.cols <= 0) return static_cast<int>(cudaSuccess);
  const RKernel k = rows_kernel(entry, form, vec);
  const long long grid = p.rows * p.blocks_per_row;
  if (k == nullptr || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || p.vpt < 1 || p.vpt > kMaxVpt || p.span < 1 ||
      p.cols % vec != 0 || p.span % vec != 0 ||
      p.blocks_per_row * p.span < p.cols ||
      (p.blocks_per_row - 1) * p.span >= p.cols ||
      grid < 1 || grid > 0x7fffffffLL || p.rows > 0x7fffffffLL ||
      p.s_rows < 1 || p.rows % p.s_rows != 0 ||
      (p.scale_t != nullptr && (p.sc_rows < 1 || p.rows % p.sc_rows != 0)) ||
      ((p.a_t != nullptr || p.c_t != nullptr) &&
       (p.ac_div < 1 || p.rows % p.ac_div != 0)) ||
      (form != kDense && p.support == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      form == kIndex ? static_cast<size_t>((p.span + 31) / 32) * 4 : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  k<<<static_cast<unsigned>(grid), threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (m, h_out, g_out) <- kernel 1 on a dense fp32 mask of the same (rows,
// cols) shape, h_out a copy of grad, by the wrapper's plan
// (sparsify_plan): vec, threads, vpt, span, blocks_per_row
int dasha_update(const void* grad, const void* h, const void* g_local,
                 const void* mask, void* m, void* h_out, void* g_out,
                 float a, float scale, long long rows, long long cols,
                 int vec, int threads, int vpt, long long span,
                 long long blocks_per_row, void* stream) {
  RArgs p = {};
  p.grad = static_cast<const float*>(grad);
  p.h = static_cast<const float*>(h);
  p.gl = static_cast<const float*>(g_local);
  p.support = mask;
  p.m = static_cast<float*>(m);
  p.h_out = static_cast<float*>(h_out);
  p.g_out = static_cast<float*>(g_out);
  p.rows = rows;
  p.cols = cols;
  p.s_rows = rows;
  p.sc_rows = 1;
  p.span = span;
  p.blocks_per_row = blocks_per_row;
  p.vpt = vpt;
  p.a = a;
  p.scale = scale;
  return launch_rows(kDenseMask, p, kMaskF32, vec, threads,
                     static_cast<cudaStream_t>(stream));
}

// (m, g_out) <- kernel 1's sparsifier update of (rows, cols) fp32 rows
// in one launch:
//   delta = (grad - h) - a (g_local - h);  m = (mk delta) scale;
//   g_out = g_local + m
// mk is the row's support: form 0 none (1), 1 the (s_rows, k) int64
// indices (PAD and any index outside [0, cols) dropped), 2 / 3 an
// (s_rows, cols) fp32 / uint8 mask (its value); row r reads support row
// r % s_rows.  Where scale_t is not null, mk is times scale_t[r % sc_rows]
// and the scalar scale is not used; where a_t is not null, row r takes
// a_t[r / a_div] for a.  h_new is grad itself.  By the wrapper's plan
// (sparsify_plan): vec, threads, vpt, span, blocks_per_row.
int dasha_sparsify_update(const void* grad, const void* h,
                          const void* g_local, const void* support,
                          const void* scale_t, const void* a_t, void* m,
                          void* g_out, long long rows, long long cols,
                          long long s_rows, long long k, long long sc_rows,
                          long long a_div, float a, float scale, int form,
                          int vec, int threads, int vpt, long long span,
                          long long blocks_per_row, void* stream) {
  RArgs p = {};
  p.grad = static_cast<const float*>(grad);
  p.h = static_cast<const float*>(h);
  p.gl = static_cast<const float*>(g_local);
  p.support = support;
  p.scale_t = static_cast<const float*>(scale_t);
  p.a_t = static_cast<const float*>(a_t);
  p.m = static_cast<float*>(m);
  p.g_out = static_cast<float*>(g_out);
  p.rows = rows;
  p.cols = cols;
  p.s_rows = s_rows;
  p.k = k;
  p.sc_rows = sc_rows;
  p.ac_div = a_div;
  p.span = span;
  p.blocks_per_row = blocks_per_row;
  p.vpt = vpt;
  p.a = a;
  p.scale = scale;
  return launch_rows(kSparsify, p, form, vec, threads,
                     static_cast<cudaStream_t>(stream));
}

// (m, h_out, g_out) <- kernel 3, the fused MVR update of (rows, cols) fp32
// rows: h_new = gn + c (h - go) (c = 1 - b), then kernel 1's update on
// h_new with the mask (form 2 fp32, 3 uint8; row r reads mask row
// r % s_rows) and the scalar scale; where a_t / c_t are not null, row r
// takes a_t[r / ac_div] / c_t[r / ac_div] for a / c.  By the wrapper's
// plan.
int dasha_mvr_update(const void* gn, const void* go, const void* h,
                     const void* g_local, const void* mask, const void* a_t,
                     const void* c_t, void* m, void* h_out, void* g_out,
                     long long rows, long long cols, long long s_rows,
                     long long ac_div, float a, float c, float scale,
                     int form, int vec, int threads, int vpt,
                     long long span, long long blocks_per_row,
                     void* stream) {
  RArgs p = {};
  p.grad = static_cast<const float*>(gn);
  p.go = static_cast<const float*>(go);
  p.h = static_cast<const float*>(h);
  p.gl = static_cast<const float*>(g_local);
  p.support = mask;
  p.a_t = static_cast<const float*>(a_t);
  p.c_t = static_cast<const float*>(c_t);
  p.m = static_cast<float*>(m);
  p.h_out = static_cast<float*>(h_out);
  p.g_out = static_cast<float*>(g_out);
  p.rows = rows;
  p.cols = cols;
  p.s_rows = s_rows;
  p.sc_rows = 1;
  p.ac_div = ac_div;
  p.span = span;
  p.blocks_per_row = blocks_per_row;
  p.vpt = vpt;
  p.a = a;
  p.c = c;
  p.scale = scale;
  return launch_rows(kMvr, p, form, vec, threads,
                     static_cast<cudaStream_t>(stream));
}

// Let every cluster kernel take a cluster of 16 blocks (non-portable) and
// ask the card whether it schedules a cluster of 16 of every one of them:
// *max_cluster <- 16 if it does, else 8.  The wrapper calls this once per
// device.
int quantize_init(int* max_cluster) {
  const bool fused[2] = {false, true};
  const int vecs[3] = {1, 2, 4};
  const int vpts[4] = {1, 2, 4, 8};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bool all16 = true;
  for (bool f : fused) {
    for (int v : vecs) {
      for (int t : vpts) {
        const void* k = reinterpret_cast<const void*>(cluster_kernel(f, v, t));
        const cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return static_cast<int>(err);
        int clusters = 0;
        const cudaError_t occ =
            cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
        cudaGetLastError();             // a refusal here is an answer
        all16 = all16 && occ == cudaSuccess && clusters > 0;
      }
    }
  }
  *max_cluster = all16 ? kMaxCluster : kMaxCluster / 2;
  return static_cast<int>(cudaGetLastError());
}

// out <- row-wise QSGD of the (rows, cols) fp32 matrix x with uniforms u
// (row r read at r % u_rows) by the wrapper's plan; partials is (rows,
// blocks_per_row) fp32 scratch on the two-pass path, else unused
int quantize_rows(const void* x, const void* u, void* out, void* partials,
                  long long rows, long long cols, long long u_rows,
                  float levels, int two_pass, int vec, int vpt, int threads,
                  long long per_block, long long blocks_per_row,
                  void* stream) {
  QArgs p = {};
  p.x = static_cast<const float*>(x);
  p.u = static_cast<const float*>(u);
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.cols = cols;
  p.u_rows = u_rows;
  p.scale_rows = 1;
  p.per_block = per_block;
  p.blocks_per_row = blocks_per_row;
  p.levels = levels;
  return launch_quantize(false, p, rows, two_pass, vec, vpt, threads,
                         static_cast<cudaStream_t>(stream));
}

// The QDither estimator update of (rows, cols) fp32 rows:
//   delta = (h_new - h) - a (g_local - h);  m = QSGD(delta, u) * scale;
//   g_out = g_local + m
// u row r read at r % u_rows; scale is scale_t[r % scale_rows] when
// scale_t is not null, else the scalar; a is a_t[r / a_div] when a_t is
// not null, else the scalar
int dasha_quantize_update(const void* h_new, const void* h,
                          const void* g_local, const void* u,
                          const void* scale_t, const void* a_t, void* m,
                          void* g_out, void* partials, long long rows,
                          long long cols, long long u_rows,
                          long long scale_rows, long long a_div, float a,
                          float scale, float levels, int two_pass, int vec,
                          int vpt, int threads, long long per_block,
                          long long blocks_per_row, void* stream) {
  QArgs p = {};
  p.x = static_cast<const float*>(h_new);
  p.h = static_cast<const float*>(h);
  p.gl = static_cast<const float*>(g_local);
  p.u = static_cast<const float*>(u);
  p.scale_t = static_cast<const float*>(scale_t);
  p.a_t = static_cast<const float*>(a_t);
  p.out = static_cast<float*>(m);
  p.g_out = static_cast<float*>(g_out);
  p.partials = static_cast<float*>(partials);
  p.cols = cols;
  p.u_rows = u_rows;
  p.scale_rows = scale_rows;
  p.a_div = a_div;
  p.per_block = per_block;
  p.blocks_per_row = blocks_per_row;
  p.a = a;
  p.scale = scale;
  p.levels = levels;
  return launch_quantize(true, p, rows, two_pass, vec, vpt, threads,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
