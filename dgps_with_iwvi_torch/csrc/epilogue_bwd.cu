// Backward of the fused whitened-conditional epilogue (kernel K3).
//
// Replaces the TPU kernels dgps_with_iwvi_tpu/ops/pallas/qvar.py
// `_epi_bwd_kernel` (l.567), `_ps_bwd_kernel` (l.685, mean terms off) and
// `_qvar_bwd_kernel` (l.224, mean and sum-of-squares terms off). For
// A [L, M, N], W [D, M, M], q_mu [M, D] and the cotangents g_qv [L, D, N],
// g_ss [L, N], g_mn [L, D, N] of the forward's outputs (epilogue.cu):
//
//   root form (cov = 0):  T = W_d^T a, dt = bf16(2 g_d T),
//                         dA += W_d dt,              dW_d += a dt^T
//   covariance form:      ga = bf16(a g_d),
//                         dA += g_d (W_d a) + W_d^T ga, dW_d += ga a^T
//   prior term:           dA += 2 a g_ss                 (exact f32)
//   mean terms:           dA += q_mu g_mn, dq_mu += a g_mn^T   (bf16x3)
//
// Rounding follows the TPU kernel: A and W_d are rounded to bf16 and every
// product accumulates in f32 (mma.sync m16n8k16, bf16 in, f32 out); the
// bf16x3 mean terms split both operands into hi/lo bf16 halves and keep
// hi*hi + hi*lo + lo*hi, as `_dot3` (qvar.py:402) does.
//
// What bounds it on the H100: 6 L D M^2 N bf16 tensor-core FLOP against
// reading A and writing dA (0.132 ms at L=20, M=128, N=8192, D=8).
//
// Design: two launches, every sum in a fixed order (no float atomics), so
// dA, dW and dq_mu are bitwise repeatable.
//   1. One block per (l, 128-column tile), 8 warps, each warp a 64 x 32
//      tile of every 128 x 128 product. A's tile is read once, rounded to
//      bf16 into shared memory and into a bf16 copy in the scratch. W_d's
//      128 x 128 block is copied as f32 into a staging buffer with cp.async
//      while the block works on d - 1, then rounded to bf16 into shared
//      memory once and read by ldmatrix both as W_d and as W_d^T (.trans).
//      T and dt (or ga) stay in registers and shared memory; dt / ga goes
//      to the scratch once, so pass 2 never recomputes T. The block owns its
//      dA tile and writes it once, and writes its partial dq_mu [M, D]
//      (bf16x3 on the tensor cores).
//   2. dW_d = sum over (l, n) of a dt^T (root) or ga a^T (cov): a split-K
//      product over L * N, slice s of S summed by one block in a 3-stage
//      cp.async ring, two blocks per SM. Each block writes its partial;
//      the last block of each (d, output block) to finish (a ticket counter)
//      sums the S partials in the order s = 0..S-1, so the arrival order
//      does not enter the result. A few blocks of the same launch sum the
//      dq_mu partials in tile order.
// M is worked through in chunks of 128 rows, padded with zeros in the
// kernel (zero rows of A and W add nothing to any sum), and a ragged last
// column tile is padded with zeros, so every M, D and N is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

// The device functions live in a namespace named for the kernel, so
// that a profiler's rows name it (SYMBOLS in ops/hopper/cost.py).
namespace k3_epilogue_bwd {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kTN = 128;          // columns per tile (pass 1)
constexpr int kC = 128;           // rows per chunk of M
constexpr int kLD = kTN + 8;      // bf16 row stride of 128-wide tiles (272 B)
constexpr int kDC = 16;           // d per chunk of the mean terms
constexpr int kLDQ = kDC + 8;     // bf16 row stride of the q_mu split
constexpr int kBK = 64;           // k per stage (pass 2)
constexpr int kLDK = kBK + 8;     // bf16 row stride of a pass-2 stage
constexpr int kStages = 3;
constexpr int kMaxSlices = 32;

typedef float Acc[4][4][4];       // warp tile 64 x 32: [m16][n8][fragment]

__host__ __device__ constexpr int padded_m(int m) {
  return (m + kC - 1) / kC * kC;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- tensor-core tiles -----------------------------------------------------

// A operand (16 x 16 at rows m0, depth k0) of X stored [m][k] (kT false)
// or [k][m] (kT true).
template <bool kT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X,
                                       int ld, int m0, int k0, int lane) {
  if (!kT)
    ldsm_x4(a, X + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  else
    ldsm_x4_t(a, X + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                     ((lane >> 3) & 1) * 8);
}

// B operands of the two n8 tiles at columns n0 and n0 + 8, depth k0..k0+15,
// of Y stored [n][k] (kT false) or [k][n] (kT true): b[0], b[1] of the
// first tile, b[2], b[3] of the second.
template <bool kT>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* Y,
                                       int ld, int n0, int k0, int lane) {
  if (!kT)
    ldsm_x4(b, Y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                   ((lane >> 3) & 1) * 8);
  else
    ldsm_x4_t(b, Y + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                     (lane >> 4) * 8);
}

// acc (the warp's 64 x 32 tile at (wm, wn)) += X Y over depth [0, K).
template <bool kTA, bool kTB, int K>
__device__ __forceinline__ void warp_mma(Acc& acc, const bf16* X, int ldx,
                                         const bf16* Y, int ldy, int wm,
                                         int wn, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      load_a<kTA>(a[mt], X, ldx, wm + mt * 16, k0, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      load_b<kTB>(b[np], Y, ldy, wn + np * 16, k0, lane);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                 b[nt >> 1][(nt & 1) * 2 + 1]);
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
}

// ---- pass 1: dA per (l, column tile), dt / ga and bf16(A) to the scratch,
// the tile's partial dq_mu ---------------------------------------------------

struct Smem {
  bf16* A16;   // [kC][kLD] a chunk of A's tile, bf16
  bf16* Ds;    // [kC][kLD] dt or ga (also A's low half for dq_mu)
  bf16* W16;   // [kC][kLD] a block of W_d, bf16
  bf16* Qh;    // [kC][kLDQ] q_mu's high half (rows of a chunk, 16 d)
  bf16* Ql;    //            and low half
  bf16* Gh;    // [kDC][kLD] g_mn's high half (16 d, the tile's columns)
  bf16* Gl;    //            and low half
  float* Wst;  // [kC][kC] the next W block, f32, copied by cp.async
  float* Gs;   // [kTN] the tile's g_d
};

constexpr size_t kTileBytes = (size_t)kC * kLD * sizeof(bf16);
constexpr size_t kSmem1 = 3 * kTileBytes +
                          2 * (size_t)kC * kLDQ * sizeof(bf16) +
                          2 * (size_t)kDC * kLD * sizeof(bf16) +
                          (size_t)kC * kC * sizeof(float) +
                          (size_t)kTN * sizeof(float);

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.A16 = reinterpret_cast<bf16*>(raw);
  s.Ds = s.A16 + kC * kLD;
  s.W16 = s.Ds + kC * kLD;
  s.Qh = s.W16 + kC * kLD;
  s.Ql = s.Qh + kC * kLDQ;
  s.Gh = s.Ql + kC * kLDQ;
  s.Gl = s.Gh + kDC * kLD;
  s.Wst = reinterpret_cast<float*>(s.Gl + kDC * kLD);
  s.Gs = s.Wst + kC * kC;
  return s;
}

// Rows [m0, m0 + 128) x columns [n0, n0 + 128) of X [M, N] (f32), zeros
// past M and N, times scale[c] where given: rounded to bf16 into hi (smem),
// the remainder x - hi rounded into lo (where given), and hi into gdst (row
// stride ldg, where given).
__device__ __forceinline__ void load_tile(bf16* hi, bf16* lo, bf16* gdst,
                                          size_t ldg, const float* X, int m0,
                                          int M, int n0, int N,
                                          const float* scale) {
  const bool vec = (N & 3) == 0;
#pragma unroll 4
  for (int i = 0; i < kC * kTN / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 5, c = (idx & 31) << 2;
    const int m = m0 + r, n = n0 + c;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < M) {
      const float* src = X + (size_t)m * N + n;
      if (vec) {
        if (n < N) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) v[e] = __ldg(src + e);
      }
    }
    if (scale != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= scale[c + e];
    }
    const uint2 h = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    *reinterpret_cast<uint2*>(hi + r * kLD + c) = h;
    if (gdst != nullptr)
      *reinterpret_cast<uint2*>(gdst + (size_t)r * ldg + c) = h;
    if (lo != nullptr) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = v[e] - round_bf16(v[e]);
      *reinterpret_cast<uint2*>(lo + r * kLD + c) =
          make_uint2(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]));
    }
  }
}

// gdst [128 rows, stride ldg] = the 128 x 128 bf16 tile src.
__device__ __forceinline__ void store_tile(bf16* gdst, size_t ldg,
                                           const bf16* src) {
#pragma unroll
  for (int i = 0; i < kC * kTN / 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, c = (idx & 15) << 3;
    *reinterpret_cast<uint4*>(gdst + (size_t)r * ldg + c) =
        *reinterpret_cast<const uint4*>(src + r * kLD + c);
  }
}

// Qh/Ql [r][j] = split(q_mu[m0 + r, d0 + j]), zeros past M and D.
__device__ __forceinline__ void load_q_split(const Smem& sm, const float* qmu,
                                             int m0, int M, int d0, int D) {
  for (int idx = threadIdx.x; idx < kC * kDC; idx += kThreads) {
    const int r = idx >> 4, j = idx & (kDC - 1);
    const int m = m0 + r, d = d0 + j;
    const float v = (m < M && d < D) ? qmu[(size_t)m * D + d] : 0.0f;
    const bf16 h = __float2bfloat16_rn(v);
    sm.Qh[r * kLDQ + j] = h;
    sm.Ql[r * kLDQ + j] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// Gh/Gl [j][c] = split(g_mn_l[d0 + j, n0 + c]), zeros past D and N.
__device__ __forceinline__ void load_g_split(const Smem& sm, const float* gm,
                                             int d0, int D, int n0, int N) {
  for (int idx = threadIdx.x; idx < kDC * kTN; idx += kThreads) {
    const int j = idx >> 7, c = idx & (kTN - 1);
    const int d = d0 + j, n = n0 + c;
    const float v = (d < D && n < N) ? gm[(size_t)d * N + n] : 0.0f;
    const bf16 h = __float2bfloat16_rn(v);
    sm.Gh[j * kLD + c] = h;
    sm.Gl[j * kLD + c] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// The W block cache: W16 holds block `have` (bf16), Wst receives block
// `staged` (f32, in flight). A tag is (d * C + block row) * C + block column.
struct WCache {
  int have = -1, staged = -1;
};

// cp.async of W_d's (br, bc) 128 x 128 block into Wst, zeros past M.
__device__ __forceinline__ void w_issue(float* Wst, const float* W, int M,
                                        int C, int tag) {
  const int d = tag / (C * C), rest = tag % (C * C);
  const int br = rest / C, bc = rest % C;
  const float* Wd = W + (size_t)d * M * M;
  if ((M & 3) == 0) {
    for (int idx = threadIdx.x; idx < kC * kC / 4; idx += kThreads) {
      const int r = idx >> 5, c = (idx & 31) << 2;
      const int m = br * kC + r, k = bc * kC + c;
      const int bytes = m < M ? min(max((M - k) * 4, 0), 16) : 0;
      const float* src = bytes > 0 ? Wd + (size_t)m * M + k : W;
      cp_async16(Wst + r * kC + c, src, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < kC * kC; idx += kThreads) {
      const int r = idx >> 7, c = idx & (kC - 1);
      const int m = br * kC + r, k = bc * kC + c;
      const bool in = m < M && k < M;
      cp_async4(Wst + r * kC + c, in ? Wd + (size_t)m * M + k : W,
                in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Make W16 hold block `tag`: wait for it in Wst (issuing it first unless
// prefetched), round to bf16. Called by every thread alike.
__device__ __forceinline__ void w_acquire(const Smem& sm, WCache& wc,
                                          const float* W, int M, int C,
                                          int tag) {
  if (tag == wc.have) return;
  if (tag != wc.staged) {
    cp_async_wait<0>();
    __syncthreads();  // nobody reads Wst any more
    w_issue(sm.Wst, W, M, C, tag);
  }
  cp_async_wait<0>();
  __syncthreads();  // Wst complete for every thread; W16 no longer read
  for (int idx = threadIdx.x; idx < kC * kC / 4; idx += kThreads) {
    const int r = idx >> 5, c = (idx & 31) << 2;
    const float4 v = *reinterpret_cast<const float4*>(sm.Wst + r * kC + c);
    *reinterpret_cast<uint2*>(sm.W16 + r * kLD + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  __syncthreads();
  wc.have = tag;
  wc.staged = -1;
}

// Start copying block `tag` into Wst while W16 is in use.
__device__ __forceinline__ void w_prefetch(const Smem& sm, WCache& wc,
                                           const float* W, int M, int C,
                                           int tag) {
  if (wc.staged != -1 || tag == wc.have) return;
  w_issue(sm.Wst, W, M, C, tag);
  wc.staged = tag;
}

__global__ void __launch_bounds__(kThreads, 1)
pass1_kernel(const float* __restrict__ A, const float* __restrict__ W,
             const float* __restrict__ qmu, const float* __restrict__ gqv,
             const float* __restrict__ gss, const float* __restrict__ gmn,
             float* __restrict__ dA, bf16* __restrict__ A16g,
             bf16* __restrict__ Rg, float* __restrict__ dq_part,
             unsigned* __restrict__ counters, int n_counters, int l0, int L,
             int M, int D, int N, int cov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int Mp = padded_m(M), C = Mp / kC;
  const int tiles = gridDim.x, Np = tiles * kTN;
  const int nt_idx = blockIdx.x, l = l0 + blockIdx.y;
  const int n0 = nt_idx * kTN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const float* Al = A + (size_t)l * M * N;
  const bool mean = qmu != nullptr;
  const int dchunks = (D + kDC - 1) / kDC;

  if (l0 == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = tid; i < n_counters; i += kThreads) counters[i] = 0u;

  // every chunk of A's tile: bf16 copy to the scratch, partial dq_mu
  int resident = -1;
  for (int kc = 0; kc < C; ++kc) {
    __syncthreads();  // A16 and Ds free
    load_tile(sm.A16, mean ? sm.Ds : nullptr,
              A16g + ((size_t)l * Mp + kc * kC) * Np + n0, Np, Al, kc * kC,
              M, n0, N, nullptr);
    resident = kc;
    if (!mean) continue;
    for (int dc = 0; dc < dchunks; ++dc) {
      __syncthreads();  // the tile is in; Gh/Gl free
      load_g_split(sm, gmn + (size_t)l * D * N, dc * kDC, D, n0, N);
      __syncthreads();
      // dq[m, d] = sum_n a[m, n] g_mn[d, n]: warp w takes rows 16 w
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kTN; k0 += 16) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        load_a<false>(ah, sm.A16, kLD, warp * 16, k0, lane);
        load_a<false>(al, sm.Ds, kLD, warp * 16, k0, lane);
        load_b<false>(bh, sm.Gh, kLD, 0, k0, lane);
        load_b<false>(bl, sm.Gl, kLD, 0, k0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(acc[nt], ah, bh[2 * nt], bh[2 * nt + 1]);
          mma_bf16(acc[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
          mma_bf16(acc[nt], al, bh[2 * nt], bh[2 * nt + 1]);
        }
      }
      float* out = dq_part + ((size_t)l * tiles + nt_idx) * M * D;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = kc * kC + warp * 16 + g + (q >> 1) * 8;
          const int d = dc * kDC + nt * 8 + t4 * 2 + (q & 1);
          if (m < M && d < D) out[(size_t)m * D + d] = acc[nt][q];
        }
    }
  }
  __syncthreads();

  WCache wc;
  auto tag = [C](int d, int br, int bc) { return (d * C + br) * C + bc; };
  auto ensure_a = [&](int kc) {
    if (kc == resident) return;
    __syncthreads();
    load_tile(sm.A16, nullptr, nullptr, 0, Al, kc * kC, M, n0, N, nullptr);
    resident = kc;
    __syncthreads();
  };

  for (int r = 0; r < C; ++r) {  // the 128-row chunk of dA
    Acc accD;
    zero(accD);
    if (mean) {  // q_mu g_mn at bf16x3
      for (int dc = 0; dc < dchunks; ++dc) {
        __syncthreads();
        load_q_split(sm, qmu, r * kC, M, dc * kDC, D);
        load_g_split(sm, gmn + (size_t)l * D * N, dc * kDC, D, n0, N);
        __syncthreads();
        warp_mma<false, true, kDC>(accD, sm.Qh, kLDQ, sm.Gh, kLD, wm, wn,
                                   lane);
        warp_mma<false, true, kDC>(accD, sm.Qh, kLDQ, sm.Gl, kLD, wm, wn,
                                   lane);
        warp_mma<false, true, kDC>(accD, sm.Ql, kLDQ, sm.Gh, kLD, wm, wn,
                                   lane);
      }
    }
    for (int d = 0; d < D; ++d) {
      const float* gq = gqv + ((size_t)l * D + d) * N;
      __syncthreads();  // Gs free
      for (int j = tid; j < kTN; j += kThreads)
        sm.Gs[j] = n0 + j < N ? gq[n0 + j] : 0.0f;
      const bool next = C == 1 && d + 1 < D;
      if (!cov) {
        for (int mc = 0; mc < C; ++mc) {
          // T = rows mc of W_d^T a: W_d's (kc, mc) blocks, read transposed
          Acc accT;
          zero(accT);
          for (int kc = 0; kc < C; ++kc) {
            ensure_a(kc);
            w_acquire(sm, wc, W, M, C, tag(d, kc, mc));
            if (next) w_prefetch(sm, wc, W, M, C, tag(d + 1, 0, 0));
            warp_mma<true, true, kC>(accT, sm.W16, kLD, sm.A16, kLD, wm, wn,
                                     lane);
          }
          __syncthreads();  // Ds no longer read; Gs written
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int row = wm + mt * 16 + g, col = wn + nt * 8 + t4 * 2;
              const float s0 = 2.0f * sm.Gs[col], s1 = 2.0f * sm.Gs[col + 1];
              *reinterpret_cast<uint32_t*>(sm.Ds + row * kLD + col) =
                  pack_bf16(s0 * accT[mt][nt][0], s1 * accT[mt][nt][1]);
              *reinterpret_cast<uint32_t*>(sm.Ds + (row + 8) * kLD + col) =
                  pack_bf16(s0 * accT[mt][nt][2], s1 * accT[mt][nt][3]);
            }
          __syncthreads();
          if (r == 0)
            store_tile(Rg + (((size_t)d * L + l) * Mp + mc * kC) * Np + n0,
                       Np, sm.Ds);
          // dA += W_d's (r, mc) block times dt
          w_acquire(sm, wc, W, M, C, tag(d, r, mc));
          warp_mma<false, true, kC>(accD, sm.W16, kLD, sm.Ds, kLD, wm, wn,
                                    lane);
        }
      } else {
        // g_d (W_d a): W_d's (r, kc) blocks against a
        Acc accS;
        zero(accS);
        for (int kc = 0; kc < C; ++kc) {
          ensure_a(kc);
          w_acquire(sm, wc, W, M, C, tag(d, r, kc));
          if (next) w_prefetch(sm, wc, W, M, C, tag(d + 1, 0, 0));
          warp_mma<false, true, kC>(accS, sm.W16, kLD, sm.A16, kLD, wm, wn,
                                    lane);
        }
        __syncthreads();  // Gs written
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = wn + nt * 8 + t4 * 2;
            const float g0 = sm.Gs[col], g1 = sm.Gs[col + 1];
            accD[mt][nt][0] += g0 * accS[mt][nt][0];
            accD[mt][nt][1] += g1 * accS[mt][nt][1];
            accD[mt][nt][2] += g0 * accS[mt][nt][2];
            accD[mt][nt][3] += g1 * accS[mt][nt][3];
          }
        // W_d^T ga, ga = bf16(a g_d): W_d's (kc, r) blocks, read transposed
        for (int kc = 0; kc < C; ++kc) {
          __syncthreads();  // Ds no longer read
          load_tile(sm.Ds, nullptr,
                    r == 0 ? Rg + (((size_t)d * L + l) * Mp + kc * kC) * Np +
                                 n0
                           : nullptr,
                    Np, Al, kc * kC, M, n0, N, sm.Gs);
          w_acquire(sm, wc, W, M, C, tag(d, kc, r));
          __syncthreads();  // Ds complete
          warp_mma<true, true, kC>(accD, sm.W16, kLD, sm.Ds, kLD, wm, wn,
                                   lane);
        }
      }
    }

    // dA = the terms above + 2 a g_ss (exact f32)
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r * kC + wm + mt * 16 + g + h * 8;
          const int n = n0 + wn + nt * 8 + t4 * 2;
          if (m >= M || n >= N) continue;
          float v0 = accD[mt][nt][2 * h], v1 = accD[mt][nt][2 * h + 1];
          const size_t at = ((size_t)l * M + m) * N + n;
          if (pairs) {  // n + 1 < N
            if (gss != nullptr) {
              const float2 a = *reinterpret_cast<const float2*>(Al +
                                                                (size_t)m * N +
                                                                n);
              const float2 s = *reinterpret_cast<const float2*>(
                  gss + (size_t)l * N + n);
              v0 += 2.0f * a.x * s.x;
              v1 += 2.0f * a.y * s.y;
            }
            *reinterpret_cast<float2*>(dA + at) = make_float2(v0, v1);
          } else {
            for (int e = 0; e < 2 && n + e < N; ++e) {
              float v = e == 0 ? v0 : v1;
              if (gss != nullptr)
                v += 2.0f * Al[(size_t)m * N + n + e] *
                     gss[(size_t)l * N + n + e];
              dA[at + e] = v;
            }
          }
        }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// ---- pass 2: dW as a split-K product, dq_mu's fixed-order sum --------------

constexpr size_t kStageElems = 2 * (size_t)kC * kLDK;  // X and Y tiles
constexpr size_t kSmem2 = kStages * kStageElems * sizeof(bf16);

// cp.async of 128 rows x kBK columns of X and of Y (row stride ldg).
__device__ __forceinline__ void issue_stage(bf16* st, const bf16* Xg,
                                            const bf16* Yg, size_t ldg) {
#pragma unroll
  for (int i = 0; i < kC * kBK / 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) << 3;
    cp_async16(st + r * kLDK + c, Xg + (size_t)r * ldg + c, 16);
    cp_async16(st + kC * kLDK + r * kLDK + c, Yg + (size_t)r * ldg + c, 16);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
pass2_kernel(const bf16* __restrict__ A16g, const bf16* __restrict__ Rg,
             float* __restrict__ dW_part, float* __restrict__ dW,
             const float* __restrict__ dq_part, float* __restrict__ dqmu,
             unsigned* __restrict__ counters, int L, int M, int D, int Np,
             int S, int n_red, int n_dq_parts, int cov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int b = blockIdx.x;
  if (b < n_red) {  // dq_mu: partials summed in tile order
    const int MD = M * D;
    const int e = b * kThreads + tid;
    if (e < MD) {
      float v = 0.0f;
#pragma unroll 8
      for (int p = 0; p < n_dq_parts; ++p) v += dq_part[(size_t)p * MD + e];
      dqmu[e] = v;
    }
    return;
  }
  b -= n_red;
  const int Mp = padded_m(M), C = Mp / kC;
  const int s = b % S, rest = b / S;
  const int blk = rest % (C * C), d = rest / (C * C);
  const int bp = blk / C, bq = blk % C;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int ktn = Np / kBK;
  const long long kt_total = (long long)L * ktn;
  const int t0 = (int)(kt_total * s / S), t1 = (int)(kt_total * (s + 1) / S);
  const int nk = t1 - t0;
  const size_t slab = (size_t)L * Mp * Np;
  // dW_d[p, q] = sum_k X[p, k] Y[q, k]
  const bf16* Xd = (cov ? Rg + d * slab : A16g) + (size_t)bp * kC * Np;
  const bf16* Yd = (cov ? A16g : Rg + d * slab) + (size_t)bq * kC * Np;
  bf16* st0 = reinterpret_cast<bf16*>(smem_raw);

  auto issue = [&](int i) {
    const int t = t0 + i, l = t / ktn, k0 = (t - l * ktn) * kBK;
    const size_t off = (size_t)l * Mp * Np + k0;
    issue_stage(st0 + (i % kStages) * kStageElems, Xd + off, Yd + off, Np);
  };

  Acc acc;
  zero(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i is in; stage (i - 1) % kStages is free
    if (i + kStages - 1 < nk) issue(i + kStages - 1);
    cp_async_commit();
    const bf16* st = st0 + (i % kStages) * kStageElems;
    warp_mma<false, false, kBK>(acc, st, kLDK, st + kC * kLDK, kLDK, wm, wn,
                                lane);
  }
  cp_async_wait<0>();

  const size_t part_stride = (size_t)D * Mp * Mp;
  float* part = dW_part + (size_t)s * part_stride +
                ((size_t)d * Mp + bp * kC) * Mp + bq * kC;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm + mt * 16 + g + h * 8;
        const int q = wn + nt * 8 + t4 * 2;
        *reinterpret_cast<float2*>(part + (size_t)p * Mp + q) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[(d * C + bp) * C + bq], 1u) ==
                       (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the S partials of this block of dW_d, in slice order
  const float* base = dW_part + ((size_t)d * Mp + bp * kC) * Mp + bq * kC;
  constexpr int kPer = kC * kC / 4 / kThreads;  // float4 per thread
  constexpr int kGroup = 8;
#pragma unroll 1
  for (int i0 = 0; i0 < kPer; i0 += kGroup) {
    float4 v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sl = 0; sl < S; ++sl) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int pos = tid + (i0 + j) * kThreads;
        const int row = pos >> 5, c4 = (pos & 31) << 2;
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            base + sl * part_stride + (size_t)row * Mp + c4));
        v[j].x += x.x, v[j].y += x.y, v[j].z += x.z, v[j].w += x.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int pos = tid + (i0 + j) * kThreads;
      const int p = bp * kC + (pos >> 5), q = bq * kC + ((pos & 31) << 2);
      const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      if (p < M)
        for (int k = 0; k < 4 && q + k < M; ++k)
          dW[((size_t)d * M + p) * M + q + k] = e[k];
    }
  }
}

// ---- scratch ---------------------------------------------------------------

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

struct Layout {
  int Mp, C, tiles, Np, S;
  size_t a16, r, dw, dq, cnt;  // byte sizes of the five parts
};

Layout layout(int L, int M, int N, int D, int with_mean) {
  Layout s;
  s.Mp = padded_m(M);
  s.C = s.Mp / kC;
  s.tiles = (N + kTN - 1) / kTN;
  s.Np = s.tiles * kTN;
  const long long kt_total = (long long)L * (s.Np / kBK);
  // at least 16 k-tiles per slice: the last block's sum of the S partials
  // stays short against the slices' own work
  s.S = (int)std::max(1LL, std::min<long long>(kMaxSlices,
                                               (kt_total + 15) / 16));
  const size_t slab = (size_t)L * s.Mp * s.Np * sizeof(bf16);
  s.a16 = align256(slab);
  s.r = align256((size_t)D * slab);
  s.dw = align256((size_t)s.S * D * s.Mp * s.Mp * sizeof(float));
  s.dq = with_mean ? align256((size_t)L * s.tiles * M * D * sizeof(float))
                   : 0;
  s.cnt = align256((size_t)D * s.C * s.C * sizeof(unsigned));
  return s;
}

}  // namespace k3_epilogue_bwd

using namespace k3_epilogue_bwd;

extern "C" {

// Bytes of the scratch `epilogue_bwd_launch` takes.
long long epilogue_bwd_scratch_bytes(int L, int M, int N, int D,
                                     int with_mean) {
  const Layout s = layout(L, M, N, D, with_mean);
  return (long long)(s.a16 + s.r + s.dw + s.dq + s.cnt);
}

// A [L, M, N], W [D, M, M], q_mu [M, D] (or null), g_qv [L, D, N],
// g_ss [L, N] (or null), g_mn [L, D, N] (null iff q_mu is null) ->
// dA [L, M, N], dW [D, M, M], dq_mu [M, D] (null iff q_mu is null).
// scratch: epilogue_bwd_scratch_bytes(L, M, N, D, q_mu != null) bytes,
// 256-byte aligned. All contiguous f32; any M, D, N. Two launches (one
// more per 65535 of L). Returns the CUDA error code of the launches (0 on
// success).
int epilogue_bwd_launch(const float* A, const float* W, const float* qmu,
                        const float* gqv, const float* gss, const float* gmn,
                        float* dA, float* dW, float* dqmu, void* scratch,
                        int L, int M, int N, int D, int cov, int device,
                        void* stream) {
  const bool mean = qmu != nullptr;
  if (L <= 0 || M <= 0 || N <= 0 || D <= 0 || gqv == nullptr ||
      mean != (gmn != nullptr) || mean != (dqmu != nullptr) ||
      (mean && gss == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout s = layout(L, M, N, D, mean);
  unsigned char* base = reinterpret_cast<unsigned char*>(scratch);
  bf16* A16g = reinterpret_cast<bf16*>(base);
  bf16* Rg = reinterpret_cast<bf16*>(base + s.a16);
  float* dW_part = reinterpret_cast<float*>(base + s.a16 + s.r);
  float* dq_part = reinterpret_cast<float*>(base + s.a16 + s.r + s.dw);
  unsigned* counters =
      reinterpret_cast<unsigned*>(base + s.a16 + s.r + s.dw + s.dq);
  const int n_counters = D * s.C * s.C;

  err = cudaFuncSetAttribute(pass1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pass2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem2);
  if (err != cudaSuccess) return (int)err;

  // pass 1; grid.y is at most 65535: slices of L
  for (int l0 = 0; l0 < L; l0 += 65535) {
    dim3 grid(s.tiles, std::min(L - l0, 65535));
    pass1_kernel<<<grid, kThreads, kSmem1, st>>>(
        A, W, qmu, gqv, gss, gmn, dA, A16g, Rg, dq_part, counters, n_counters,
        l0, L, M, D, N, cov);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // pass 2: the dq_mu sums first, then S slices of every (d, block of dW)
  const int n_red = mean ? (M * D + kThreads - 1) / kThreads : 0;
  const long long blocks = n_red + (long long)s.S * D * s.C * s.C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pass2_kernel<<<(int)blocks, kThreads, kSmem2, st>>>(
      A16g, Rg, dW_part, dW, dq_part, dqmu, counters, L, M, D, s.Np, s.S,
      n_red, L * s.tiles, cov);
  return (int)cudaGetLastError();
}

const char* epilogue_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
