// Hand-written Hopper (sm_90a) kernel of the Mamba2 SSD intra-chunk block
// (replaces repro/kernels/ssd_chunk.py:ssd_chunk_pallas, body
// _ssd_chunk_kernel), on the tensor cores:
//
//   acs    = cumsum(dt * A)                     (Q,)     inclusive
//   y_diag = (tril(exp(acs_q - acs_k)) * c b^T) (x dt)   (Q, P)
//   state  = b^T (exp(acs_end - acs) * x dt)    (N, P)
//   decay  = exp(acs_end)
//
// Inputs are read in place in the model's layout — x (B, S, H, P), dt
// (B, S, H), b/c (B, S, N) — through row strides; outputs are float32 in
// the reference's (G, nc, ...) layout, g = batch * H + head.
//
// Grid (head group, chunk, batch).  b and c do not depend on the head
// (Mamba2 has one group), so a block forms the score tiles c b^T once
// for its (batch, chunk) and reuses them for every head of its group:
// at the serving prefill shape (B 4, S 32,768, H 48, P 64, N 128, Q 256)
// the scores cost 2 * 512 * 32,896 * 128 = 4.3 GFLOP a layer, once per
// (batch, chunk) and head group (three groups of 16: 12.9 GFLOP), where
// forming them per head cost ~207 GFLOP.  The work the inputs need is
// then ~211 GFLOP a layer: y_diag 103.5 (the lower triangle), states
// 103.1.  The head group is the wrapper's choice (ssd_chunk.py:plan): at
// most 16 heads, as many as the shared memory holds, split evenly, so
// that the serving shape runs 1,536 blocks of 16 heads on 132 SMs.
//
// Arithmetic: mma.sync with float32 accumulation, dispatched on the
// input type.  One TF32 or bf16 pass of a float32 operand is ~5e-4 off,
// outside the 1e-4 gate, so float32 operands are split into parts whose
// products are exact in float32:
//   bf16 inputs (the serving path): m16n8k16 bf16.  c b^T in one pass
//     (bf16 products are exact).  dt is folded into y_diag's A = L * S
//     * dt and w dt into the states' A = b * w dt, each split into three
//     bf16 parts (hi + mid + lo holds ~24 bits); B = x is bf16 itself,
//     exact, read straight from the staged tile by ldmatrix.trans: 3
//     passes, no conversion pass.  Three bf16 passes ran 8% faster than
//     two TF32 passes (hi/lo of A, x exact in TF32) at the serving shape
//     (3.94 against 4.28 ms a layer, chip_smoke.py phase 7 on an H100
//     80GB HBM3 at 700 W), and agree as closely.
//   float32 inputs: m16n8k8 TF32, both operands split into hi = tf32(v)
//     and lo = v - hi, 3 passes (hi*hi + hi*lo + lo*hi, ~2^-22 of |v|);
//     x dt (and w x dt) converted once a tile into hi/lo in shared memory.
// Counted with its passes, the bf16 path runs ~633 GFLOP of bf16 a layer
// at the serving shape (0.64 ms at 989 TFLOP/s), so its 3.3 GB of reads
// and writes (0.99 ms) bound it.
//
// Per block: the group's dt, acs (cumsum, one warp a head) and state
// weights; then per 64-row query tile the score panel S[q, 0:64(qt+1))
// in shared memory (at most 64 x 256 float32), and per pair of work
// units — a unit is a head's 64-column slab of P — the key tiles kt <=
// qt: x streamed by cp.async (16-byte copies where strides and pointers
// allow, scalar loads otherwise) into a double-buffered stage and
// multiplied on the tensor cores by L * S, which each warp forms in
// registers (exp only where k <= q: above the diagonal acs_q - acs_k > 0
// can overflow).  On the diagonal tile a warp skips the steps wholly
// above its 16 rows; the second unit's warps take the m-tiles in reverse
// order, so each scheduler gets equal work there.  bf16 inputs keep
// every b tile of the chunk in shared memory, and the last query tile's
// pass, which streams every key tile of each unit, forms the unit's
// states from the same staged x; float32 inputs run a states pass that
// streams b and x again.  Four warps own a unit (16 query rows, or 16/32
// state rows, by 64 columns each); eight warps run two units at once.
// Ragged Q, N and P are zero-padded in shared memory up to the mma tile.
// No atomics: every output element is written by one thread, in a fixed
// order, so two launches are bit-identical.
//
// Plain C interface for ctypes: launches on the caller's stream, never
// synchronizes, allocates nothing, returns a cudaError_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps: two units of four warps
constexpr int kTile = 64;             // query / key rows of a tile
constexpr int kMaxSmem = 232448;      // 227 KB, the most a block may use
constexpr int kMaxWidth = 128;        // the largest N and P
constexpr int kMaxChunk = 256;        // the largest Q

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// v = hi + lo with hi = v rounded to TF32 (to nearest, ties away: add
// half of the 13 dropped bits to the magnitude, then clear them) and lo =
// v - hi exactly; the tensor core reads lo's top 10 mantissa bits, so the
// pair holds v to ~2^-22 of |v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}
// the two bf16 of a 32-bit word as TF32 operands (exact): low, high half
__device__ __forceinline__ uint32_t bf16_lo(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t v) {
  return v & 0xffff0000u;
}
// (v0, v1) as three bf16 pairs hi + mid + lo (v0 in the low halves): each
// part is what the previous ones leave, exactly, so the three hold v to
// ~2^-24 of |v|
__device__ __forceinline__ void split3_bf16x2(float v0, float v1,
                                              uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  auto pack = [](float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  };
  hi = pack(v0, v1);
  v0 = __fsub_rn(v0, __uint_as_float(bf16_lo(hi)));
  v1 = __fsub_rn(v1, __uint_as_float(bf16_hi(hi)));
  mid = pack(v0, v1);
  v0 = __fsub_rn(v0, __uint_as_float(bf16_lo(mid)));
  v1 = __fsub_rn(v1, __uint_as_float(bf16_hi(mid)));
  lo = pack(v0, v1);
}
// four 8 x 8 bf16 matrices, transposed: each lane's row address from
// lanes 8i..8i+7 for matrix i; a thread (g, t) receives rows 2t and
// 2t + 1 of column g of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 64 rows x WIDTH columns of T (rows of a row-strided matrix, `rows` of
// them valid, `cols` columns valid) into dst[r * ld + k], zero past the
// valid rows and columns.  16-byte cp.async copies when `vec` (pointer,
// strides and valid columns 16-byte aligned), else scalar loads.
template <int WIDTH, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int kChunks = WIDTH / E;
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kChunks;
      const int k = (e % kChunks) * E;
      const bool ok = r < rows && k < cols;
      const T* s = ok ? src + static_cast<long long>(r) * stride + k : src;
      cp_async16(dst + r * ld + k, s, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * WIDTH; e += kThreads) {
      const int r = e / WIDTH;
      const int k = e % WIDTH;
      dst[r * ld + k] = (r < rows && k < cols)
                            ? src[static_cast<long long>(r) * stride + k]
                            : zero_of<T>();
    }
  }
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
  int H, nc, Q, P, N, hg;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// The converted x dt of a unit: for column p and key octet o, 16 floats
// {hi(k), hi(k + 4), lo(k), lo(k + 4)} for k = 8o + t, t = 0..3, the four
// slots XOR-swizzled by (p >> 1) & 3, so that one 16-byte load gives a
// thread both B fragments of a TF32 mma (hi and lo) and neither the
// writes nor the reads conflict.  Rows of 144 floats (128 + 16).
constexpr int kConvRow = 144;
constexpr int kConvUnit = kTile * kConvRow;

// The shared-memory plan; ssd_chunk.py:smem_bytes computes the same bytes.
struct Layout {
  int tiles, qp, npad, ldn, ldx, ldp;
  size_t acs, dt, w, conv, stage, u, bytes;   // byte offsets, then total
};

__host__ __device__ inline Layout layout(int elem_bytes, int Q, int N,
                                         int hg) {
  Layout l;
  l.tiles = (Q + kTile - 1) / kTile;
  l.qp = l.tiles * kTile;
  l.npad = N > kTile ? 2 * kTile : kTile;
  l.ldn = l.npad + 16 / elem_bytes;         // b / c tiles
  l.ldx = kTile + 16 / elem_bytes;          // staged x slabs
  l.ldp = l.qp + 8;                         // score panel
  const size_t head_arr = static_cast<size_t>(hg) * l.qp * 4;
  const size_t conv = 2 * static_cast<size_t>(kConvUnit) * 4;
  // the score pass's tiles: float32 c and one b; bf16 every b of the chunk
  const size_t bc = (elem_bytes == 2 ? l.tiles : 2) *
                    static_cast<size_t>(kTile) * l.ldn * elem_bytes;
  const size_t stage = 2 * 2 * static_cast<size_t>(kTile) * l.ldx *
                       elem_bytes;
  const size_t panel = static_cast<size_t>(kTile) * l.ldp * 4;
  l.acs = 0;
  l.dt = head_arr;
  l.w = 2 * head_arr;
  l.conv = 3 * head_arr;                    // b (and c) tiles alias it
  l.stage = l.conv + (conv > bc ? conv : bc);
  l.u = l.stage + stage;                    // the panel
  // the float32 states pass's double-buffered b tiles reuse the panel
  const size_t bst = elem_bytes == 2 ? 0 : bc;
  l.bytes = l.u + (panel > bst ? panel : bst);
  return l;
}

// One block per (head group, chunk, batch); see the note at the top.
template <typename T, bool M2>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(Params prm) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int NPAD = M2 ? 2 * kTile : kTile;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int Q = prm.Q, P = prm.P, N = prm.N, H = prm.H;
  const Layout L = layout(sizeof(T), Q, N, prm.hg);
  const int qp = L.qp, ldn = L.ldn, ldx = L.ldx, ldp = L.ldp;
  float* acs_s = reinterpret_cast<float*>(smem + L.acs);   // (hg, qp)
  float* dt_s = reinterpret_cast<float*>(smem + L.dt);     // (hg, qp)
  float* w_s = reinterpret_cast<float*>(smem + L.w);       // (hg, qp)
  float* conv = reinterpret_cast<float*>(smem + L.conv);   // 2 units
  T* stage = reinterpret_cast<T*>(smem + L.stage);         // (2, 2, 64, ldx)
  // the score pass's c tile and b tiles: float32 inputs load one b tile
  // at a time into the conversion region; bf16 inputs, which convert
  // nothing, keep every b tile of the chunk there (tile kt at slot kt,
  // loaded once, read again by the fused states) and the c tile in the
  // stage, which the score pass does not use
  T* cs = kBf16 ? stage : reinterpret_cast<T*>(smem + L.conv);
  auto bslot = [&](int kt) {
    return reinterpret_cast<T*>(smem + L.conv) +
           (kBf16 ? kt : 1) * kTile * ldn;
  };
  float* panel = reinterpret_cast<float*>(smem + L.u);     // (64, ldp)
  T* bstage = reinterpret_cast<T*>(smem + L.u);   // float32: (2, 64, ldn)

  const int h0 = blockIdx.x * prm.hg;
  const int nh = min(prm.hg, H - h0);
  const int chunk = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;             // the mma fragment's row group
  const int t = lane & 3;              // and its thread in the group
  const int quad = warp >> 2;          // which of the two running units
  // this warp's 16-row m-tile; mirrored in the second unit, so that
  // each scheduler (warp % 4) gets equal work on a diagonal tile
  const int mi = quad ? 3 - (warp & 3) : warp & 3;
  const int slot = (t ^ ((g >> 1) & 3)) * 4;   // its swizzled conv slot
  const long long s0 = static_cast<long long>(chunk) * Q;
  const T* x = static_cast<const T*>(prm.x) + bi * prm.x_sb + s0 * prm.x_ss;
  const T* dt = static_cast<const T*>(prm.dt) + bi * prm.dt_sb +
                s0 * prm.dt_ss;
  const T* b = static_cast<const T*>(prm.b) + bi * prm.b_sb + s0 * prm.b_ss;
  const T* c = static_cast<const T*>(prm.c) + bi * prm.c_sb + s0 * prm.c_ss;
  const bool xvec = reinterpret_cast<uintptr_t>(prm.x) % 16 == 0 &&
                    prm.x_sb % E == 0 && prm.x_ss % E == 0 && P % E == 0;
  const bool bvec = reinterpret_cast<uintptr_t>(prm.b) % 16 == 0 &&
                    prm.b_sb % E == 0 && prm.b_ss % E == 0 && N % E == 0;
  const bool cvec = reinterpret_cast<uintptr_t>(prm.c) % 16 == 0 &&
                    prm.c_sb % E == 0 && prm.c_ss % E == 0 && N % E == 0;
  const int pg = P > kTile ? 2 : 1;    // 64-column slabs of a head
  const int units = nh * pg;
  const int pairs = (units + 1) / 2;
  auto out_row = [&](int hh) {
    return static_cast<long long>(bi * H + h0 + hh) * prm.nc + chunk;
  };
  // two results of an accumulator fragment at row r, columns p and p + 1
  // of an output tile with P columns
  auto put = [&](float* base, int r, int p, float v0, float v1) {
    float* dst = base + static_cast<long long>(r) * P + p;
    if (p + 1 < P) {
      if (P % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        dst[1] = v1;
      }
    } else if (p < P) {
      dst[0] = v0;
    }
  };

  // --- dt, acs = cumsum(dt * A), w = exp(acs_end - acs); zero past Q ----
  for (int e = tid; e < nh * qp; e += kThreads) {
    const int hh = e / qp;
    const int q = e - hh * qp;
    dt_s[e] = q < Q ? to_f32(dt[q * prm.dt_ss + h0 + hh]) : 0.0f;
    acs_s[e] = 0.0f;
  }
  __syncthreads();
  for (int hh = warp; hh < nh; hh += kThreads / 32) {  // a warp a head
    const float a = prm.A[h0 + hh];
    const float* d = dt_s + hh * qp;
    float* ac = acs_s + hh * qp;
    const int per = (Q + 31) / 32;     // runs of consecutive rows
    const int q0 = lane * per;
    float run = 0.0f;
    for (int i = 0; i < per; ++i) {
      const int q = q0 + i;
      if (q < Q) {
        run = __fadd_rn(run, __fmul_rn(d[q], a));
        ac[q] = run;
      }
    }
    float incl = run;                  // inclusive scan of the run totals
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane > 0) {
      for (int i = 0; i < per; ++i) {
        const int q = q0 + i;
        if (q < Q) ac[q] = __fadd_rn(ac[q], excl);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nh * qp; e += kThreads) {
    const int hh = e / qp;
    const int q = e - hh * qp;
    const float* ac = acs_s + hh * qp;
    // bf16 inputs: w * dt, folded into the states' A operand
    const float w = expf(__fsub_rn(ac[Q - 1], ac[q]));
    w_s[e] = q < Q ? (kBf16 ? __fmul_rn(w, dt_s[e]) : w) : 0.0f;
    if (q < Q) prm.acs[out_row(hh) * Q + q] = ac[q];
  }
  for (int hh = tid; hh < nh; hh += kThreads) {
    prm.decays[out_row(hh)] = expf(acs_s[hh * qp + Q - 1]);
  }

  // the x slabs of a pair of units at key tile kt into stage buffer buf
  auto issue_x = [&](int buf, int pair, int kt) {
    for (int s = 0; s < 2; ++s) {
      const int u = 2 * pair + s;
      if (u >= units) break;
      const int hh = u / pg;
      const int half = u - hh * pg;
      load_tile<kTile>(stage + (buf * 2 + s) * kTile * ldx, ldx,
                       x + static_cast<long long>(kt) * kTile * prm.x_ss +
                           static_cast<long long>(h0 + hh) * P +
                           half * kTile,
                       prm.x_ss, min(kTile, Q - kt * kTile),
                       min(kTile, P - half * kTile), xvec);
    }
  };
  // stage buffer buf -> hi/lo of x dt (times w for the states), one
  // rounding a product as the plain version does; a thread takes a
  // column p and a key octet, 4 of them a tile
  auto convert = [&](int buf, int pair, int kt, bool weighted) {
#pragma unroll
    for (int i = 0; i < 2 * kTile * 8 / kThreads; ++i) {
      const int item = tid + i * kThreads;
      const int s = item >> 9;         // 512 (column, octet) items a unit
      const int p = item & (kTile - 1);
      const int oct = (item >> 6) & 7;
      const int u = 2 * pair + s;
      if (u >= units) continue;
      const int hh = u / pg;
      const T* src = stage + (buf * 2 + s) * kTile * ldx + 8 * oct * ldx + p;
      const float* d = dt_s + hh * qp + kt * kTile + 8 * oct;
      const float* wk = w_s + hh * qp + kt * kTile + 8 * oct;
      float* dst = conv + s * kConvUnit + p * kConvRow + 16 * oct;
      const int sw = (p >> 1) & 3;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        float v0 = __fmul_rn(to_f32(src[tt * ldx]), d[tt]);
        float v1 = __fmul_rn(to_f32(src[(tt + 4) * ldx]), d[tt + 4]);
        if (weighted) {
          v0 = __fmul_rn(wk[tt], v0);
          v1 = __fmul_rn(wk[tt + 4], v1);
        }
        uint32_t h0b, l0b, h1b, l1b;
        split_tf32(v0, h0b, l0b);
        split_tf32(v1, h1b, l1b);
        *reinterpret_cast<float4*>(dst + 4 * (tt ^ sw)) = make_float4(
            __uint_as_float(h0b), __uint_as_float(h1b),
            __uint_as_float(l0b), __uint_as_float(l1b));
      }
    }
  };
  // this warp's unit's converted tile
  const float* my_conv = conv + quad * kConvUnit + g * kConvRow + slot;

  constexpr int MT = M2 ? 2 : 1;       // 16-row m-tiles of N a warp owns
  // bf16 states of unit hh's key tile kt (x in stage buffer buf, b at bt):
  // 16-key steps of m16n8k16 bf16, A = b * (w dt) split into three bf16
  // parts, B = x, exact, by ldmatrix.trans (3 passes)
  auto states_bf16 = [&](float (&acc)[MT][8][4], const T* bt, int buf,
                         int kt, int hh) {
    const float* wd = w_s + hh * qp + kt * kTile + 2 * t;
    const uint32_t xaddr = static_cast<uint32_t>(__cvta_generic_to_shared(
        stage + (buf * 2 + quad) * kTile * ldx +
        ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldx + 8 * (lane >> 4)));
    const uint32_t baddr = static_cast<uint32_t>(__cvta_generic_to_shared(
        bt + ((lane & 7) + 8 * (lane >> 4)) * ldn + 16 * mi +
        8 * ((lane >> 3) & 1)));
    const int kend16 = min(kTile, (Q - kt * kTile + 15) / 16 * 16);
    for (int ks = 0; ks < kend16; ks += 16) {
      uint32_t xb[16];                 // b0, b1 of n-tiles 2jj, 2jj + 1
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ldsm_x4_trans(xb + 4 * jj, xaddr + 2 * ks * ldx + 32 * jj);
      }
      const float2 w0 = *reinterpret_cast<const float2*>(wd + ks);
      const float2 w1 = *reinterpret_cast<const float2*>(wd + ks + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t br[4];                // rows n, n + 8 x keys 2t.., 2t + 8..
        ldsm_x4_trans(br, baddr + 2 * (ks * ldn + 64 * m));
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 w = i < 2 ? w0 : w1;
          split3_bf16x2(__fmul_rn(__uint_as_float(bf16_lo(br[i])), w.x),
                        __fmul_rn(__uint_as_float(bf16_hi(br[i])), w.y),
                        hi[i], mid[i], lo[i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t b0 = xb[4 * (j / 2) + 2 * (j % 2)];
          const uint32_t b1 = xb[4 * (j / 2) + 2 * (j % 2) + 1];
          mma_bf16(acc[m][j], lo, b0, b1);
          mma_bf16(acc[m][j], mid, b0, b1);
          mma_bf16(acc[m][j], hi, b0, b1);
        }
      }
    }
  };
  // a unit's finished states, written out; the accumulators cleared
  auto store_states = [&](float (&acc)[MT][8][4], int u) {
    const int hh = u / pg;
    const int half = u - hh * pg;
    float* st = prm.states + out_row(hh) * N * P;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = half * kTile + 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * mi + 64 * m + g + 8 * r;
          if (n < N) put(st, n, p, acc[m][j][2 * r], acc[m][j][2 * r + 1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
      }
    }
  };

  for (int qt = 0; qt < L.tiles; ++qt) {
    // --- the score panel S[q, 0:64(qt+1)) = c b^T, once for all heads --
    auto score_tile = [&](int kt, const T* bs) {
      float s[4][4];                   // 16 rows x 32 keys of this warp
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
      const T* ca = cs + (16 * mi + g) * ldn;
      const T* cb = ca + 8 * ldn;
      if constexpr (kBf16) {
#pragma unroll 4
        for (int k0 = 0; k0 < NPAD; k0 += 16) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ca + k0 + 2 * t);
          a[1] = *reinterpret_cast<const uint32_t*>(cb + k0 + 2 * t);
          a[2] = *reinterpret_cast<const uint32_t*>(ca + k0 + 2 * t + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(cb + k0 + 2 * t + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* br = bs + (32 * quad + 8 * j + g) * ldn + k0 + 2 * t;
            mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(br),
                     *reinterpret_cast<const uint32_t*>(br + 8));
          }
        }
      } else {
#pragma unroll 2
        for (int k0 = 0; k0 < NPAD; k0 += 8) {
          uint32_t ah[4], al[4];
          split_tf32(to_f32(ca[k0 + t]), ah[0], al[0]);
          split_tf32(to_f32(cb[k0 + t]), ah[1], al[1]);
          split_tf32(to_f32(ca[k0 + t + 4]), ah[2], al[2]);
          split_tf32(to_f32(cb[k0 + t + 4]), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* br = bs + (32 * quad + 8 * j + g) * ldn + k0 + t;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(to_f32(br[0]), bh0, bl0);
            split_tf32(to_f32(br[4]), bh1, bl1);
            mma_tf32(s[j], al, bh0, bh1);
            mma_tf32(s[j], ah, bl0, bl1);
            mma_tf32(s[j], ah, bh0, bh1);
          }
        }
      }
      float* pr = panel + (16 * mi + g) * ldp + kt * kTile + 32 * quad +
                  2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(pr + 8 * j) = make_float2(s[j][0],
                                                             s[j][1]);
        *reinterpret_cast<float2*>(pr + 8 * ldp + 8 * j) =
            make_float2(s[j][2], s[j][3]);
      }
    };
    auto load_b = [&](T* dst, int kt) {
      load_tile<NPAD>(dst, ldn, b + static_cast<long long>(kt) * kTile *
                      prm.b_ss, prm.b_ss, min(kTile, Q - kt * kTile), N,
                      bvec);
    };
    load_tile<NPAD>(cs, ldn, c + static_cast<long long>(qt) * kTile *
                    prm.c_ss, prm.c_ss, min(kTile, Q - qt * kTile), N, cvec);
    if constexpr (kBf16) {             // b tiles 0..qt-1 are resident
      load_b(bslot(qt), qt);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int kt = 0; kt <= qt; ++kt) score_tile(kt, bslot(kt));
      __syncthreads();                 // cs is read; the stage is free
    } else {
      for (int kt = 0; kt <= qt; ++kt) {
        load_b(bslot(kt), kt);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        score_tile(kt, bslot(kt));
        __syncthreads();               // bs is read; the next b tile
      }
    }

    // --- y_diag of the query tile, per pair of units: key tiles kt <= qt
    {
      const int nk = qt + 1;
      const int total = pairs * nk;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
      // bf16: the last query tile's pass streams every key tile of each
      // unit, so it forms the unit's states too, from the resident b tiles
      const bool with_states = kBf16 && qt == L.tiles - 1;
      float sacc[MT][8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[m][j][i] = 0.0f;
      const int row = 16 * mi + g;     // local query row (and row + 8)
      issue_x(0, 0, 0);
      cp_async_commit();
      for (int it = 0; it < total; ++it) {
        const int pair = it / nk;
        const int kt = it - pair * nk;
        const int buf = it & 1;
        cp_async_wait_all();
        __syncthreads();               // the stage landed; conv is free
        if constexpr (!kBf16) convert(buf, pair, kt, false);
        if (it + 1 < total) {
          issue_x(buf ^ 1, (it + 1) / nk, (it + 1) % nk);
        }
        cp_async_commit();
        if constexpr (!kBf16) __syncthreads();   // conv is written
        const int u = 2 * pair + quad;
        if (u >= units) continue;
        const int hh = u / pg;
        const float* ac = acs_s + hh * qp;
        const float aq0 = ac[qt * kTile + row];
        const float aq1 = ac[qt * kTile + row + 8];
        const float* ak = ac + kt * kTile;
        const float* p0 = panel + row * ldp + kt * kTile;
        const float* p1 = p0 + 8 * ldp;
        const float* dk = dt_s + hh * qp + kt * kTile;
        auto ls = [](bool on, float acs_q, float acs_k, float sc) {
          return on ? __fmul_rn(__expf(__fsub_rn(acs_q, acs_k)), sc) : 0.0f;
        };
        // float32 inputs: 8-key steps, mma-k t and t + 4 at keys t and
        // t + 4; the A fragment is L * S masked before exp (on the
        // diagonal tile only keys k <= q count), split hi/lo, and B the
        // converted hi/lo of x dt (3 passes)
        auto step8 = [&](int ks, bool diag) {
          const int k0 = ks + t;
          const int k1 = k0 + 4;
          float v[4];                  // (row, k0), (row + 8, k0), (row,
          v[0] = ls(!diag || k0 <= row, aq0, ak[k0], p0[k0]);      // k1),
          v[1] = ls(!diag || k0 <= row + 8, aq1, ak[k0], p1[k0]);  // (row
          v[2] = ls(!diag || k1 <= row, aq0, ak[k1], p0[k1]);      // + 8,
          v[3] = ls(!diag || k1 <= row + 8, aq1, ak[k1], p1[k1]);  // k1)
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[i], al[i]);
          const float* bp = my_conv + 2 * ks;        // 16 floats an octet
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 bf = *reinterpret_cast<const float4*>(
                bp + 8 * j * kConvRow);
            const uint32_t bh0 = __float_as_uint(bf.x);
            const uint32_t bh1 = __float_as_uint(bf.y);
            mma_tf32(acc[j], al, bh0, bh1);
            mma_tf32(acc[j], ah, __float_as_uint(bf.z),
                     __float_as_uint(bf.w));
            mma_tf32(acc[j], ah, bh0, bh1);
          }
        };
        // bf16 inputs: 16-key steps of m16n8k16 bf16; A = L * S * dt (dt
        // folded in) split into three bf16 parts, B = x itself, exact in
        // bf16, straight from the stage by ldmatrix.trans (3 passes)
        const uint32_t xaddr = static_cast<uint32_t>(__cvta_generic_to_shared(
            stage + (buf * 2 + quad) * kTile * ldx +
            ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldx + 8 * (lane >> 4)));
        auto step16 = [&](int ks, bool diag) {
          uint32_t hi[4], mid[4], lo[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {          // keys ks + 8h + 2t, + 1
            const int k = ks + 8 * h + 2 * t;
            const float2 e = *reinterpret_cast<const float2*>(ak + k);
            const float2 d = *reinterpret_cast<const float2*>(dk + k);
            const float2 r0 = *reinterpret_cast<const float2*>(p0 + k);
            const float2 r1 = *reinterpret_cast<const float2*>(p1 + k);
            split3_bf16x2(
                __fmul_rn(ls(!diag || k <= row, aq0, e.x, r0.x), d.x),
                __fmul_rn(ls(!diag || k + 1 <= row, aq0, e.y, r0.y), d.y),
                hi[2 * h], mid[2 * h], lo[2 * h]);
            split3_bf16x2(
                __fmul_rn(ls(!diag || k <= row + 8, aq1, e.x, r1.x), d.x),
                __fmul_rn(ls(!diag || k + 1 <= row + 8, aq1, e.y, r1.y),
                          d.y),
                hi[2 * h + 1], mid[2 * h + 1], lo[2 * h + 1]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {       // n-tiles 2jj, 2jj + 1
            uint32_t xb[4];
            ldsm_x4_trans(xb, xaddr + 2 * ks * ldx + 32 * jj);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              float* a = acc[2 * jj + q];
              mma_bf16(a, lo, xb[2 * q], xb[2 * q + 1]);
              mma_bf16(a, mid, xb[2 * q], xb[2 * q + 1]);
              mma_bf16(a, hi, xb[2 * q], xb[2 * q + 1]);
            }
          }
        };
        // steps wholly above the diagonal tile's rows are skipped
        if constexpr (kBf16) {
          if (kt < qt) {
#pragma unroll
            for (int ks = 0; ks < kTile; ks += 16) step16(ks, false);
          } else {
            for (int ks = 0; ks < 16 * (mi + 1); ks += 16) step16(ks, true);
          }
        } else {
          if (kt < qt) {
#pragma unroll
            for (int ks = 0; ks < kTile; ks += 8) step8(ks, false);
          } else {
            for (int ks = 0; ks < 16 * (mi + 1); ks += 8) step8(ks, true);
          }
        }
        if constexpr (kBf16) {
          if (with_states) {
            states_bf16(sacc, bslot(kt), buf, kt, hh);
            if (kt == nk - 1) store_states(sacc, u);
          }
        }
        if (kt == nk - 1) {            // the unit's tile is complete
          const int half = u - hh * pg;
          const int rows = min(kTile, Q - qt * kTile);
          float* yo = prm.y + (out_row(hh) * Q + qt * kTile) * P;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = half * kTile + 8 * j + 2 * t;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (row + 8 * r < rows) {
                put(yo, row + 8 * r, p, acc[j][2 * r], acc[j][2 * r + 1]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
          }
        }
      }
      __syncthreads();                 // panel and conv are read
    }
  }

  // --- float32: states = b^T (w * x dt), per pair of units over all key
  //     tiles, from the converted hi/lo of w x dt (3 TF32 passes) -------
  if constexpr (!kBf16) {
    const int total = pairs * L.tiles;
    float acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
    auto issue_bx = [&](int buf, int pair, int kt) {
      load_tile<NPAD>(bstage + buf * kTile * ldn, ldn,
                      b + static_cast<long long>(kt) * kTile * prm.b_ss,
                      prm.b_ss, min(kTile, Q - kt * kTile), N, bvec);
      issue_x(buf, pair, kt);
    };
    issue_bx(0, 0, 0);
    cp_async_commit();
    for (int it = 0; it < total; ++it) {
      const int pair = it / L.tiles;
      const int kt = it - pair * L.tiles;
      const int buf = it & 1;
      cp_async_wait_all();
      __syncthreads();
      convert(buf, pair, kt, true);
      if (it + 1 < total) {
        issue_bx(buf ^ 1, (it + 1) / L.tiles, (it + 1) % L.tiles);
      }
      cp_async_commit();
      __syncthreads();
      const int u = 2 * pair + quad;
      if (u >= units) continue;
      const T* bt = bstage + buf * kTile * ldn + 16 * mi + g;
      const int kend = min(kTile, (Q - kt * kTile + 7) / 8 * 8);
#pragma unroll 2
      for (int ks = 0; ks < kend; ks += 8) {
        const float* bp = my_conv + 2 * ks;
        float4 bf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bf[j] = *reinterpret_cast<const float4*>(bp + 8 * j * kConvRow);
        }
        const T* a0 = bt + (ks + t) * ldn;
        const T* a1 = a0 + 4 * ldn;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a[4] = {to_f32(a0[64 * m]), to_f32(a0[64 * m + 8]),
                              to_f32(a1[64 * m]), to_f32(a1[64 * m + 8])};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t bh0 = __float_as_uint(bf[j].x);
            const uint32_t bh1 = __float_as_uint(bf[j].y);
            mma_tf32(acc[m][j], al, bh0, bh1);
            mma_tf32(acc[m][j], ah, __float_as_uint(bf[j].z),
                     __float_as_uint(bf[j].w));
            mma_tf32(acc[m][j], ah, bh0, bh1);
          }
        }
      }
      if (kt == L.tiles - 1) store_states(acc, u);
    }
  }
}

template <typename T, bool M2>
cudaError_t launch(const Params& prm, int batch, cudaStream_t stream) {
  const Layout l = layout(sizeof(T), prm.Q, prm.N, prm.hg);
  if (l.bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_kernel<T, M2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  const int groups = (prm.H + prm.hg - 1) / prm.hg;
  kernel<<<dim3(groups, prm.nc, batch), kThreads, l.bytes, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& prm, int batch, cudaStream_t stream) {
  if (prm.N > 64) return launch<T, true>(prm, batch, stream);
  return launch<T, false>(prm, batch, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, b, c; A is always float32).
// hg: heads a block walks (the wrapper's plan).  Strides in elements:
// x_sb/x_ss of x's batch and sequence axes ((H, P) dense), dt_sb/dt_ss (H
// dense), b_sb/b_ss and c_sb/c_ss (N dense).
int ssd_chunk(const void* x, const void* dt, const void* A, const void* b,
              const void* c, void* y, void* states, void* decays, void* acs,
              int dtype, int batch, int H, int nc, int Q, int P, int N,
              int hg, long long x_sb, long long x_ss, long long dt_sb,
              long long dt_ss, long long b_sb, long long b_ss,
              long long c_sb, long long c_ss, void* stream) {
  if (batch < 1 || H < 1 || nc < 1 || Q < 1 || P < 1 || N < 1 || hg < 1 ||
      P > kMaxWidth || N > kMaxWidth || Q > kMaxChunk || nc > 65535 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm{x, dt, static_cast<const float*>(A), b, c,
             static_cast<float*>(y), static_cast<float*>(states),
             static_cast<float*>(decays), static_cast<float*>(acs),
             H, nc, Q, P, N, hg,
             x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(prm, batch, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(prm, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
