// Hand-written Hopper (sm_90a) kernel of the Mamba2 SSD intra-chunk block
// (replaces repro/kernels/ssd_chunk.py:ssd_chunk_pallas, body
// _ssd_chunk_kernel).  One block per (g, chunk), g = batch * H + head:
//
//   acs    = cumsum(dt * A)                     (Q,)     inclusive
//   y_diag = (tril(exp(acs_q - acs_k)) * c b^T) (x dt)   (Q, P)
//   state  = b^T (exp(acs_end - acs) * x dt)    (N, P)
//   decay  = exp(acs_end)
//
// Inputs are read in place in the model's layout — x (B, S, H, P), dt
// (B, S, H), b/c (B, S, N) — through row strides, so neither the per-head
// copy of b/c nor the (G, nc, Q, P) copy of x that the TPU wrapper makes
// exists.  Outputs are float32 in the reference's (G, nc, ...) layout.
//
// What bounds it: three products per block, ~9.9M FMA at Q = 256, N = 128,
// P = 64, against ~1.3 MB of reads and writes: operations, on the CUDA
// cores in float32 (TF32 would not meet the 1e-4 tolerance).  Design: the
// block walks 64-row query tiles; for each it walks the key tiles at or
// below the diagonal, with c^T, b^T, x*dt and the masked score tile in
// shared memory (~105 KB at the 780M shape, 2 blocks an SM) and each
// thread accumulating a 4 x 4 register tile.  exp is taken only where
// k <= q (above the diagonal acs_q - acs_k > 0 can overflow).  c b^T is
// recomputed for every head (about 2x the work the bound counts).
//
// Plain C interface for ctypes: launches on the caller's stream, never
// synchronizes, allocates nothing, returns a cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;             // query / key rows of a tile
constexpr int kLd = kTile + 4;        // row length of the transposed tiles
constexpr int kMaxSmem = 232448;      // 227 KB, the most a block may use
constexpr int kMaxWidth = 128;        // the largest N and P (NG, PG <= 2)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* b;
  const void* c;
  float* y;
  float* states;
  float* decays;
  float* acs;
  int H, nc, Q, P, N;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

size_t smem_floats(int Q, int N, int PW) {
  const size_t q4 = (static_cast<size_t>(Q) + 3) / 4 * 4;
  return 2 * static_cast<size_t>(N) * kLd + static_cast<size_t>(kTile) * PW +
         static_cast<size_t>(kTile) * kLd + 3 * q4;
}

// rows [row0, row0 + 64) of an (S, N) matrix of this batch, transposed into
// dst[n * kLd + k]; rows at or past the chunk's end are zero
template <typename T>
__device__ void load_transposed(float* dst, const T* src, long long row_stride,
                                int row0, int Q, int N) {
  for (int e = threadIdx.x; e < N * kTile; e += kThreads) {
    const int k = e / N;
    const int n = e - k * N;
    const int row = row0 + k;
    dst[n * kLd + k] =
        row < Q ? to_f32(src[static_cast<long long>(row) * row_stride + n])
                : 0.0f;
  }
}

// rows [row0, row0 + 64) of x * dt (times w when given) into dst[k * PW + p],
// zero past the chunk's end and past P
template <typename T>
__device__ void load_xdt(float* dst, const T* x, long long row_stride,
                         int row0, int Q, int P, int PW, const float* dt_s,
                         const float* w_s) {
  for (int e = threadIdx.x; e < kTile * PW; e += kThreads) {
    const int k = e / PW;
    const int p = e - k * PW;
    const int row = row0 + k;
    float v = 0.0f;
    if (row < Q && p < P) {
      v = __fmul_rn(to_f32(x[static_cast<long long>(row) * row_stride + p]),
                    dt_s[row]);
      if (w_s != nullptr) v = __fmul_rn(w_s[row], v);
    }
    dst[k * PW + p] = v;
  }
}

template <typename T, int NG, int PG>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(Params prm) {
  constexpr int PW = kTile * PG;       // padded row width of the x tile
  extern __shared__ float4 smem4[];
  const int Q = prm.Q, P = prm.P, N = prm.N;
  float* cT = reinterpret_cast<float*>(smem4);   // (N, kLd)
  float* bT = cT + N * kLd;                       // (N, kLd)
  float* xs = bT + N * kLd;                       // (kTile, PW)
  float* ss = xs + kTile * PW;                    // (kTile, kLd)
  float* dt_s = ss + kTile * kLd;                 // (Q,)
  const int q4 = (Q + 3) / 4 * 4;
  float* acs_s = dt_s + q4;
  float* w_s = acs_s + q4;

  const int chunk = blockIdx.x;
  const int g = blockIdx.y;
  const int bi = g / prm.H;
  const int h = g - bi * prm.H;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long s0 = static_cast<long long>(chunk) * Q;
  const long long out_row = static_cast<long long>(g) * prm.nc + chunk;

  const T* x = static_cast<const T*>(prm.x) + bi * prm.x_sb + s0 * prm.x_ss +
               static_cast<long long>(h) * P;
  const T* dt = static_cast<const T*>(prm.dt) + bi * prm.dt_sb +
                s0 * prm.dt_ss + h;
  const T* b = static_cast<const T*>(prm.b) + bi * prm.b_sb + s0 * prm.b_ss;
  const T* c = static_cast<const T*>(prm.c) + bi * prm.c_sb + s0 * prm.c_ss;

  // --- dt, acs = cumsum(dt * A), decay weights ---------------------------
  for (int q = tid; q < Q; q += kThreads) {
    dt_s[q] = to_f32(dt[static_cast<long long>(q) * prm.dt_ss]);
  }
  __syncthreads();
  if (tid < 32) {                      // one warp: runs of consecutive rows
    const float a = prm.A[h];
    const int per = (Q + 31) / 32;
    const int q0 = tid * per;
    float run = 0.0f;
    for (int i = 0; i < per; ++i) {
      const int q = q0 + i;
      if (q < Q) {
        run = __fadd_rn(run, __fmul_rn(dt_s[q], a));
        acs_s[q] = run;
      }
    }
    float incl = run;                  // inclusive scan of the run totals
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0f;
    if (tid > 0) {
      for (int i = 0; i < per; ++i) {
        const int q = q0 + i;
        if (q < Q) acs_s[q] = __fadd_rn(acs_s[q], excl);
      }
    }
  }
  __syncthreads();
  const float acs_end = acs_s[Q - 1];
  for (int q = tid; q < Q; q += kThreads) {
    w_s[q] = expf(__fsub_rn(acs_end, acs_s[q]));
    prm.acs[out_row * Q + q] = acs_s[q];
  }
  if (tid == 0) prm.decays[out_row] = expf(acs_end);
  const int tiles = (Q + kTile - 1) / kTile;

  // --- state = b^T (w * x dt): rows n = ty*4+i (+64r), cols p = tx*4+j
  //     (+64m) -------------------------------------------------------------
  {
    float acc[NG][4][PG][4];
#pragma unroll
    for (int r = 0; r < NG; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < PG; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][i][m][j] = 0.0f;
    int nrow[NG][4];                   // clamped: rows past N are not stored
#pragma unroll
    for (int r = 0; r < NG; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) nrow[r][i] = min(ty * 4 + i + 64 * r, N - 1);

    for (int kt = 0; kt < tiles; ++kt) {
      __syncthreads();                 // the previous tile's readers are done
      load_transposed(bT, b, prm.b_ss, kt * kTile, Q, N);
      load_xdt(xs, x, prm.x_ss, kt * kTile, Q, P, PW, dt_s, w_s);
      __syncthreads();
      for (int k = 0; k < kTile; ++k) {
        float bv[NG][4];
#pragma unroll
        for (int r = 0; r < NG; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[r][i] = bT[nrow[r][i] * kLd + k];
#pragma unroll
        for (int m = 0; m < PG; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[k * PW + tx * 4 + 64 * m]);
#pragma unroll
          for (int r = 0; r < NG; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[r][i][m][0] = fmaf(bv[r][i], xv.x, acc[r][i][m][0]);
              acc[r][i][m][1] = fmaf(bv[r][i], xv.y, acc[r][i][m][1]);
              acc[r][i][m][2] = fmaf(bv[r][i], xv.z, acc[r][i][m][2]);
              acc[r][i][m][3] = fmaf(bv[r][i], xv.w, acc[r][i][m][3]);
            }
        }
      }
    }
    float* st = prm.states + out_row * N * P;
#pragma unroll
    for (int r = 0; r < NG; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty * 4 + i + 64 * r;
        if (n >= N) continue;
#pragma unroll
        for (int m = 0; m < PG; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx * 4 + j + 64 * m;
            if (p < P) st[static_cast<long long>(n) * P + p] = acc[r][i][m][j];
          }
      }
  }

  // --- y_diag: per query tile, the key tiles at or below the diagonal ----
  for (int qt = 0; qt < tiles; ++qt) {
    const int q0 = qt * kTile;
    float acc[4][PG][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < PG; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][m][j] = 0.0f;
    __syncthreads();
    load_transposed(cT, c, prm.c_ss, q0, Q, N);
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * kTile;
      if (kt > 0) __syncthreads();     // the previous key tile's readers
      load_transposed(bT, b, prm.b_ss, k0, Q, N);
      load_xdt(xs, x, prm.x_ss, k0, Q, P, PW, dt_s, nullptr);
      __syncthreads();
      // scores = c b^T on this (query, key) tile
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(&cT[n * kLd + ty * 4]);
        const float4 bv =
            *reinterpret_cast<const float4*>(&bT[n * kLd + tx * 4]);
        const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cq[i], bk[j], s[i][j]);
      }
      // L * scores, masked before exp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        float out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + tx * 4 + j;
          out[j] = (k <= q && q < Q)
                       ? __fmul_rn(expf(__fsub_rn(acs_s[q], acs_s[k])),
                                   s[i][j])
                       : 0.0f;
        }
        *reinterpret_cast<float4*>(&ss[(ty * 4 + i) * kLd + tx * 4]) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
      __syncthreads();
      // y += (L * scores) (x dt)
      for (int k = 0; k < kTile; ++k) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = ss[(ty * 4 + i) * kLd + k];
#pragma unroll
        for (int m = 0; m < PG; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[k * PW + tx * 4 + 64 * m]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][m][0] = fmaf(sv[i], xv.x, acc[i][m][0]);
            acc[i][m][1] = fmaf(sv[i], xv.y, acc[i][m][1]);
            acc[i][m][2] = fmaf(sv[i], xv.z, acc[i][m][2]);
            acc[i][m][3] = fmaf(sv[i], xv.w, acc[i][m][3]);
          }
        }
      }
    }
    float* yo = prm.y + out_row * Q * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= Q) continue;
#pragma unroll
      for (int m = 0; m < PG; ++m) {
        const int p = tx * 4 + 64 * m;
        float* dst = yo + static_cast<long long>(q) * P + p;
        if (P % 4 == 0 && p < P) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[i][m][0], acc[i][m][1], acc[i][m][2], acc[i][m][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (p + j < P) dst[j] = acc[i][m][j];
          }
        }
      }
    }
  }
}

template <typename T, int NG, int PG>
cudaError_t launch(const Params& prm, int G, cudaStream_t stream) {
  const size_t bytes = smem_floats(prm.Q, prm.N, kTile * PG) * sizeof(float);
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_kernel<T, NG, PG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(prm.nc, G), kThreads, bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& prm, int G, cudaStream_t stream) {
  const bool n2 = prm.N > 64;
  const bool p2 = prm.P > 64;
  if (n2 && p2) return launch<T, 2, 2>(prm, G, stream);
  if (n2) return launch<T, 2, 1>(prm, G, stream);
  if (p2) return launch<T, 1, 2>(prm, G, stream);
  return launch<T, 1, 1>(prm, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c; A is always float32).
// Strides in elements: x_sb/x_ss of x's batch and sequence axes ((H, P)
// dense), dt_sb/dt_ss (H dense), b_sb/b_ss and c_sb/c_ss (N dense).
int ssd_chunk(const void* x, const void* dt, const void* A, const void* b,
              const void* c, void* y, void* states, void* decays, void* acs,
              int dtype, int batch, int H, int nc, int Q, int P, int N,
              long long x_sb, long long x_ss, long long dt_sb,
              long long dt_ss, long long b_sb, long long b_ss,
              long long c_sb, long long c_ss, void* stream) {
  if (batch < 1 || H < 1 || nc < 1 || Q < 1 || P < 1 || N < 1 ||
      P > kMaxWidth || N > kMaxWidth ||
      static_cast<long long>(batch) * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm{x, dt, static_cast<const float*>(A), b, c,
             static_cast<float*>(y), static_cast<float*>(states),
             static_cast<float*>(decays), static_cast<float*>(acs),
             H, nc, Q, P, N, x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  const int G = batch * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(prm, G, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(prm, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
