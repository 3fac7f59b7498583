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
// reading A and writing dA. At the flagship training shape (L=20, M=128,
// N=512) the D=8 inner layer is 8.1e9 FLOP, 8 us at 989 TF/s, and its
// bytes take 4 us: far below a launch's latency, so the design aims at
// being right and deterministic, not at the roofline (wgmma and TMA come
// later).
//
// Design. The TPU summed dW and dq_mu over its sequential grid in one VMEM
// block. Blocks on the card run in no order, and float atomics would make
// the sum change from run to run, so the sums are in three passes, each
// in a fixed order:
//   1. dA: one block per (l, 128-column tile). It owns its dA tile, so it
//      writes it once, no reduction across blocks. Each of the 8 warps owns
//      16 columns and all rows of a 128-row chunk of the product, as in
//      epilogue.cu. For the root form T is recomputed per d in registers,
//      dt is rounded into shared memory (the warp's own columns) and fed
//      back to the tensor cores. The block also writes its partial
//      dq_mu [M, D] over its 128 columns.
//   2. dW: one block per (s, 128x128 block of dW_d, d). Block s takes the
//      column tiles s, s + S, s + 2S, ... in order, recomputes dt (root) or
//      ga (cov) per tile and accumulates its dW block in registers, then
//      writes it as partial s. S is sized to fill the card once.
//   3. A fixed-order sum of the S partials of dW and of pass 1's dq_mu
//      partials.
// M is worked through in chunks of 128 rows, padded with zeros in the
// kernel (zero rows of A and W add nothing to any sum), and a ragged last
// column tile is padded with zeros, so every M, D and N is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;             // columns per tile
constexpr int kWN = kTN / kWarps;    // columns per warp: two n8 tiles
constexpr int kLDA = kTN + 4;        // f32 row stride of the shared A chunk
constexpr int kC = 128;              // rows per chunk of M
constexpr int kLDW = kC + 8;         // bf16 row stride of W / dt blocks
constexpr int kT = kC / 16;          // m16 tiles / k16 steps per chunk
constexpr int kWaveBlocks = 132;     // pass 2 fills the H100's SMs once

typedef float Acc[kT][2][4];         // [m tile][n8 tile][mma C fragment]
typedef uint32_t Frag[kT][2][2];     // [k step][n8 tile][mma B fragment]

__host__ __device__ constexpr int padded_m(int m) {
  return (m + kC - 1) / kC * kC;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < kT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;
}

// Wop[t, d, m, k] = bf16(t == 0 ? W[d, m, k] : W[d, k, m]) for m, k < M,
// zero up to padded_m(M): W_d and W_d^T as row-major "A" operands.
__global__ void prep_w_kernel(const float* __restrict__ W,
                              __nv_bfloat16* __restrict__ Wop, int D, int M) {
  const int Mp = padded_m(M);
  const size_t per = (size_t)D * Mp * Mp;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < 2 * per; idx += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(idx / per);
    const size_t rest = idx % per;
    const int k = (int)(rest % Mp);
    const size_t dm = rest / Mp;
    const int m = (int)(dm % Mp);
    const int d = (int)(dm / Mp);
    float v = 0.0f;
    if (m < M && k < M)
      v = t == 0 ? W[((size_t)d * M + m) * M + k]
                 : W[((size_t)d * M + k) * M + m];
    Wop[idx] = __float2bfloat16_rn(v);
  }
}

// As[r, j] = A_l[kc * kC + r, n0 + j], zeros past M and N.
__device__ __forceinline__ void load_a_chunk(float* As, const float* Al,
                                             int kc, int M, int N, int n0) {
  for (int idx = threadIdx.x; idx < kC * kTN; idx += kThreads) {
    const int r = idx / kTN, j = idx % kTN;
    const int m = kc * kC + r, n = n0 + j;
    As[r * kLDA + j] = (m < M && n < N) ? Al[(size_t)m * N + n] : 0.0f;
  }
}

// Ws = the (rc, cc) 128x128 block of Wop[t, d].
__device__ __forceinline__ void load_w_block(__nv_bfloat16* Ws,
                                             const __nv_bfloat16* Wop, int t,
                                             int d, int D, int Mp, int rc,
                                             int cc) {
  constexpr int kRowVec = kC * 2 / 16;  // uint4 per row of a block
  const uint4* src = reinterpret_cast<const uint4*>(
      Wop + (((size_t)t * D + d) * Mp + (size_t)rc * kC) * Mp +
      (size_t)cc * kC);
  uint4* dst = reinterpret_cast<uint4*>(Ws);
  for (int v = threadIdx.x; v < kC * kRowVec; v += kThreads) {
    const int r = v / kRowVec, c = v % kRowVec;
    dst[r * (kLDW * 2 / 16) + c] = src[(size_t)r * (Mp * 2 / 16) + c];
  }
}

// Gs[j] = g[n0 + j], zeros past N.
__device__ __forceinline__ void load_g(float* Gs, const float* g, int N,
                                       int n0) {
  for (int j = threadIdx.x; j < kTN; j += kThreads)
    Gs[j] = n0 + j < N ? g[n0 + j] : 0.0f;
}

// B fragments of the warp's 16 columns of a K x N operand held row-major in
// f32 shared memory (rows k, columns n), scaled per column by Gs (or not):
// b0 = (B[k][col], B[k+1][col]), b1 = rows +8.
__device__ __forceinline__ void frag_from_f32(Frag& b, const float* Xs,
                                              const float* Gs, int wc,
                                              int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kT; ++kt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = wc + nt * 8 + g;
      const int k = kt * 16 + t4 * 2;
      const float s = Gs != nullptr ? Gs[col] : 1.0f;
      b[kt][nt][0] = pack_bf16(Xs[k * kLDA + col] * s,
                               Xs[(k + 1) * kLDA + col] * s);
      b[kt][nt][1] = pack_bf16(Xs[(k + 8) * kLDA + col] * s,
                               Xs[(k + 9) * kLDA + col] * s);
    }
}

// The same from bf16 shared memory (rows k, columns n, stride kLDW).
__device__ __forceinline__ void frag_from_bf16(Frag& b,
                                               const __nv_bfloat16* Xs,
                                               int wc, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kT; ++kt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = wc + nt * 8 + g;
      const int k = kt * 16 + t4 * 2;
      __nv_bfloat162 v0, v1;
      v0.x = Xs[k * kLDW + col];
      v0.y = Xs[(k + 1) * kLDW + col];
      v1.x = Xs[(k + 8) * kLDW + col];
      v1.y = Xs[(k + 9) * kLDW + col];
      b[kt][nt][0] = *reinterpret_cast<uint32_t*>(&v0);
      b[kt][nt][1] = *reinterpret_cast<uint32_t*>(&v1);
    }
}

// acc[rows, warp's columns] += Ws (128 x 128, bf16 row-major) x b.
__device__ __forceinline__ void mma_block(Acc& acc, const __nv_bfloat16* Ws,
                                          const Frag& b, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kT; ++kt)
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      const __nv_bfloat16* w0 = Ws + (mt * 16 + g) * kLDW + kt * 16 + t4 * 2;
      const __nv_bfloat16* w8 = w0 + 8 * kLDW;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(w0);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(w8);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(w0 + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(w8 + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_bf16(acc[mt][nt], a0, a1, a2, a3, b[kt][nt][0], b[kt][nt][1]);
    }
}

// acc += X b, X (128 x 128) read row-major from f32 shared memory (rows,
// columns k) and rounded to bf16, each column k scaled by Gs (or not).
__device__ __forceinline__ void mma_block_f32(Acc& acc, const float* Xs,
                                              const float* Gs, const Frag& b,
                                              int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kT; ++kt) {
    const int k = kt * 16 + t4 * 2;
    float s[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (Gs != nullptr) {
      s[0] = Gs[k];
      s[1] = Gs[k + 1];
      s[2] = Gs[k + 8];
      s[3] = Gs[k + 9];
    }
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      const float* x0 = Xs + (mt * 16 + g) * kLDA + k;
      const float* x8 = x0 + 8 * kLDA;
      const uint32_t a0 = pack_bf16(x0[0] * s[0], x0[1] * s[1]);
      const uint32_t a1 = pack_bf16(x8[0] * s[0], x8[1] * s[1]);
      const uint32_t a2 = pack_bf16(x0[8] * s[2], x0[9] * s[3]);
      const uint32_t a3 = pack_bf16(x8[8] * s[2], x8[9] * s[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_bf16(acc[mt][nt], a0, a1, a2, a3, b[kt][nt][0], b[kt][nt][1]);
    }
  }
}

// Ds[row, col] = bf16(2 g[col] T[row, col]) for the warp's own columns.
__device__ __forceinline__ void store_dt(__nv_bfloat16* Ds, const Acc& T,
                                         const float* Gs, int wc, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c0 = wc + nt * 8 + t4 * 2;
    const float g0 = 2.0f * Gs[c0], g1 = 2.0f * Gs[c0 + 1];
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      Ds[r0 * kLDW + c0] = __float2bfloat16_rn(g0 * T[mt][nt][0]);
      Ds[r0 * kLDW + c0 + 1] = __float2bfloat16_rn(g1 * T[mt][nt][1]);
      Ds[r1 * kLDW + c0] = __float2bfloat16_rn(g0 * T[mt][nt][2]);
      Ds[r1 * kLDW + c0 + 1] = __float2bfloat16_rn(g1 * T[mt][nt][3]);
    }
  }
}

struct Smem {
  float* As;            // [kC][kLDA] a chunk of A's tile, f32
  __nv_bfloat16* Ws;    // [kC][kLDW] a block of W_d or W_d^T
  __nv_bfloat16* Ds;    // [kC][kLDW] dt (root form)
  float* Gs;            // [kTN] the tile's g_d
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.As = reinterpret_cast<float*>(raw);
  s.Ws = reinterpret_cast<__nv_bfloat16*>(s.As + kC * kLDA);
  s.Ds = s.Ws + kC * kLDW;
  s.Gs = reinterpret_cast<float*>(s.Ds + kC * kLDW);
  return s;
}

constexpr size_t kSmem = (size_t)kC * kLDA * sizeof(float) +
                         2 * (size_t)kC * kLDW * sizeof(__nv_bfloat16) +
                         (size_t)kTN * sizeof(float);

// ---- pass 1: dA per (l, column tile), and the tile's partial dq_mu --------
__global__ void __launch_bounds__(kThreads, 1)
dA_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ Wop,
          const float* __restrict__ qmu, const float* __restrict__ gqv,
          const float* __restrict__ gss, const float* __restrict__ gmn,
          float* __restrict__ dA, float* __restrict__ dqmu_part, int l0,
          int M, int D, int N, int cov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int Mp = padded_m(M);
  const int C = Mp / kC;
  const int l = l0 + blockIdx.y;
  const int tiles = gridDim.x;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp * kWN;
  const float* Al = A + (size_t)l * M * N;
  int resident = -1;  // the chunk of A in As (the same in every thread)

  // the tile's partial dq_mu[m, d] = sum_n a[m, n] g_mn[d, n], bf16x3
  if (qmu != nullptr) {
    for (int kc = 0; kc < C; ++kc) {
      __syncthreads();
      load_a_chunk(sm.As, Al, kc, M, N, n0);
      resident = kc;
      __syncthreads();
      const int rows = min(kC, M - kc * kC);
      for (int idx = tid; idx < rows * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        const float* gm = gmn + ((size_t)l * D + d) * N + n0;
        float hh = 0.0f, hl = 0.0f, lh = 0.0f;
        for (int j = 0; j < kTN && n0 + j < N; ++j) {
          const float a = sm.As[r * kLDA + j];
          const float ah = round_bf16(a), al = round_bf16(a - ah);
          const float v = gm[j];
          const float vh = round_bf16(v), vl = round_bf16(v - vh);
          hh = fmaf(ah, vh, hh);
          hl = fmaf(ah, vl, hl);
          lh = fmaf(al, vh, lh);
        }
        const size_t blk = (size_t)l * tiles + blockIdx.x;
        dqmu_part[(blk * M + kc * kC + r) * D + d] = (hh + hl) + lh;
      }
    }
  }

  Frag b;
  for (int r = 0; r < C; ++r) {  // the 128-row chunk of dA
    Acc accD;
    zero(accD);
    for (int d = 0; d < D; ++d) {
      const float* gq = gqv + ((size_t)l * D + d) * N;
      if (cov) {
        // g_d (W_d a): W_d's (r, kc) blocks against a
        Acc accS;
        zero(accS);
        for (int kc = 0; kc < C; ++kc) {
          __syncthreads();
          if (kc != resident) {
            load_a_chunk(sm.As, Al, kc, M, N, n0);
            resident = kc;
          }
          load_w_block(sm.Ws, Wop, 0, d, D, Mp, r, kc);
          if (kc == 0) load_g(sm.Gs, gq, N, n0);
          __syncthreads();
          frag_from_f32(b, sm.As, nullptr, wc, lane);
          mma_block(accS, sm.Ws, b, lane);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c0 = wc + nt * 8 + t4 * 2;
          const float g0 = sm.Gs[c0], g1 = sm.Gs[c0 + 1];
#pragma unroll
          for (int mt = 0; mt < kT; ++mt) {
            accD[mt][nt][0] += g0 * accS[mt][nt][0];
            accD[mt][nt][1] += g1 * accS[mt][nt][1];
            accD[mt][nt][2] += g0 * accS[mt][nt][2];
            accD[mt][nt][3] += g1 * accS[mt][nt][3];
          }
        }
        // W_d^T ga, ga = bf16(a g_d): W_d^T's (r, kc) blocks
        for (int kc = 0; kc < C; ++kc) {
          __syncthreads();
          if (kc != resident) {
            load_a_chunk(sm.As, Al, kc, M, N, n0);
            resident = kc;
          }
          load_w_block(sm.Ws, Wop, 1, d, D, Mp, r, kc);
          __syncthreads();
          frag_from_f32(b, sm.As, sm.Gs, wc, lane);
          mma_block(accD, sm.Ws, b, lane);
        }
      } else {
        for (int mc = 0; mc < C; ++mc) {
          // T = rows mc of W_d^T a
          Acc accT;
          zero(accT);
          for (int kc = 0; kc < C; ++kc) {
            __syncthreads();
            if (kc != resident) {
              load_a_chunk(sm.As, Al, kc, M, N, n0);
              resident = kc;
            }
            load_w_block(sm.Ws, Wop, 1, d, D, Mp, mc, kc);
            if (mc == 0 && kc == 0) load_g(sm.Gs, gq, N, n0);
            __syncthreads();
            frag_from_f32(b, sm.As, nullptr, wc, lane);
            mma_block(accT, sm.Ws, b, lane);
          }
          // dt into the warp's own columns of Ds, then dA += W_d dt
          store_dt(sm.Ds, accT, sm.Gs, wc, lane);
          __syncwarp();
          frag_from_bf16(b, sm.Ds, wc, lane);
          __syncthreads();  // every warp is done with Ws
          load_w_block(sm.Ws, Wop, 0, d, D, Mp, r, mc);
          __syncthreads();
          mma_block(accD, sm.Ws, b, lane);
        }
      }
    }

    // dA = (2 a g_ss + q_mu g_mn) + the quadratic-form terms
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int mt = 0; mt < kT; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = r * kC + mt * 16 + g + (q >> 1) * 8;
          const int n = n0 + wc + nt * 8 + t4 * 2 + (q & 1);
          if (m >= M || n >= N) continue;
          float v = 0.0f;
          if (gss != nullptr)
            v = 2.0f * Al[(size_t)m * N + n] * gss[(size_t)l * N + n];
          if (qmu != nullptr) {
            float hh = 0.0f, hl = 0.0f, lh = 0.0f;
            for (int d = 0; d < D; ++d) {
              const float x = qmu[(size_t)m * D + d];
              const float y = gmn[((size_t)l * D + d) * N + n];
              const float xh = round_bf16(x), xl = round_bf16(x - xh);
              const float yh = round_bf16(y), yl = round_bf16(y - yh);
              hh = fmaf(xh, yh, hh);
              hl = fmaf(xh, yl, hl);
              lh = fmaf(xl, yh, lh);
            }
            v += (hh + hl) + lh;
          }
          dA[((size_t)l * M + m) * N + n] = v + accD[mt][nt][q];
        }
      }
    }
  }
}

// ---- pass 2: partial s of the (i, j) block of dW_d -------------------------
__global__ void __launch_bounds__(kThreads, 1)
dW_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ Wop,
          const float* __restrict__ gqv, float* __restrict__ dW_part, int L,
          int M, int D, int N, int cov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int Mp = padded_m(M);
  const int C = Mp / kC;
  const int S = gridDim.x, s = blockIdx.x;
  const int i = blockIdx.y / C, j = blockIdx.y % C;  // rows p, columns q
  const int d = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp * kWN;
  const int ntiles = (N + kTN - 1) / kTN;

  Acc acc;  // dW_d[i rows p, j columns q]: the warp owns 16 columns q
  zero(acc);
  Frag b;
  for (int t = s; t < L * ntiles; t += S) {
    const int l = t / ntiles, n0 = (t % ntiles) * kTN;
    const float* Al = A + (size_t)l * M * N;
    const float* gq = gqv + ((size_t)l * D + d) * N;
    int resident = -1;
    if (cov) {
      // dW_d[p, q] += sum_n ga[p, n] a[q, n]: B from chunk j, A from i
      __syncthreads();
      load_a_chunk(sm.As, Al, j, M, N, n0);
      load_g(sm.Gs, gq, N, n0);
      resident = j;
      __syncthreads();
      // B[k = n][col = q] = bf16(a[q, n]): rows q of As, consecutive n
#pragma unroll
      for (int kt = 0; kt < kT; ++kt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* x = sm.As + (wc + nt * 8 + g) * kLDA + kt * 16 + t4 * 2;
          b[kt][nt][0] = pack_bf16(x[0], x[1]);
          b[kt][nt][1] = pack_bf16(x[8], x[9]);
        }
      if (i != resident) {
        __syncthreads();
        load_a_chunk(sm.As, Al, i, M, N, n0);
        __syncthreads();
      }
      mma_block_f32(acc, sm.As, sm.Gs, b, lane);
    } else {
      // T = rows j of W_d^T a, dt = bf16(2 g T) into Ds [q][n]
      Acc accT;
      zero(accT);
      for (int kc = 0; kc < C; ++kc) {
        __syncthreads();
        if (kc != resident) {
          load_a_chunk(sm.As, Al, kc, M, N, n0);
          resident = kc;
        }
        load_w_block(sm.Ws, Wop, 1, d, D, Mp, j, kc);
        if (kc == 0) load_g(sm.Gs, gq, N, n0);
        __syncthreads();
        frag_from_f32(b, sm.As, nullptr, wc, lane);
        mma_block(accT, sm.Ws, b, lane);
      }
      store_dt(sm.Ds, accT, sm.Gs, wc, lane);
      __syncthreads();  // Ds is read across warps below
      if (i != resident) {
        load_a_chunk(sm.As, Al, i, M, N, n0);
        __syncthreads();
      }
      // dW_d[p, q] += sum_n a[p, n] dt[q, n]: B[k = n][col = q] = Ds[q][n]
#pragma unroll
      for (int kt = 0; kt < kT; ++kt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* x =
              sm.Ds + (wc + nt * 8 + g) * kLDW + kt * 16 + t4 * 2;
          b[kt][nt][0] = *reinterpret_cast<const uint32_t*>(x);
          b[kt][nt][1] = *reinterpret_cast<const uint32_t*>(x + 8);
        }
      mma_block_f32(acc, sm.As, nullptr, b, lane);
    }
  }

  float* out = dW_part + (((size_t)s * D + d) * Mp + (size_t)i * kC) * Mp +
               (size_t)j * kC;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = mt * 16 + g + (q >> 1) * 8;
        const int c = wc + nt * 8 + t4 * 2 + (q & 1);
        out[(size_t)p * Mp + c] = acc[mt][nt][q];
      }
}

// ---- pass 3: fixed-order sums of the partials ------------------------------
__global__ void reduce_dW_kernel(const float* __restrict__ part, int S,
                                 int D, int M, float* __restrict__ dW) {
  const int Mp = padded_m(M);
  const size_t total = (size_t)D * M * M;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int q = (int)(idx % M);
    const int p = (int)((idx / M) % M);
    const int d = (int)(idx / ((size_t)M * M));
    float v = 0.0f;
    for (int s = 0; s < S; ++s)
      v += part[(((size_t)s * D + d) * Mp + p) * Mp + q];
    dW[idx] = v;
  }
}

__global__ void reduce_dqmu_kernel(const float* __restrict__ part, int nblk,
                                   int MD, float* __restrict__ dqmu) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < MD;
       idx += gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int b = 0; b < nblk; ++b) v += part[(size_t)b * MD + idx];
    dqmu[idx] = v;
  }
}

int n_slices(int L, int M, int N, int D) {
  const int C = padded_m(M) / kC;
  const long long tiles = (long long)L * ((N + kTN - 1) / kTN);
  const long long want = (kWaveBlocks + (long long)D * C * C - 1) /
                         ((long long)D * C * C);
  return (int)std::max(1LL, std::min(tiles, want));
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

struct Scratch {
  size_t wop, dw, dq;  // byte sizes of the three parts
};

Scratch scratch_sizes(int L, int M, int N, int D, int with_mean) {
  const size_t Mp = padded_m(M);
  const size_t tiles = (size_t)L * ((N + kTN - 1) / kTN);
  Scratch s;
  s.wop = align256(2 * (size_t)D * Mp * Mp * sizeof(__nv_bfloat16));
  s.dw = align256((size_t)n_slices(L, M, N, D) * D * Mp * Mp * sizeof(float));
  s.dq = with_mean ? align256(tiles * M * D * sizeof(float)) : 0;
  return s;
}

}  // namespace

extern "C" {

// Bytes of the scratch `epilogue_bwd_launch` takes.
long long epilogue_bwd_scratch_bytes(int L, int M, int N, int D,
                                     int with_mean) {
  const Scratch s = scratch_sizes(L, M, N, D, with_mean);
  return (long long)(s.wop + s.dw + s.dq);
}

// A [L, M, N], W [D, M, M], q_mu [M, D] (or null), g_qv [L, D, N],
// g_ss [L, N] (or null), g_mn [L, D, N] (null iff q_mu is null) ->
// dA [L, M, N], dW [D, M, M], dq_mu [M, D] (null iff q_mu is null).
// scratch: epilogue_bwd_scratch_bytes(L, M, N, D, q_mu != null) bytes,
// 256-byte aligned. All contiguous f32; any M, D, N. Returns the CUDA error
// code of the launches (0 on success).
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
  const Scratch sz = scratch_sizes(L, M, N, D, mean);
  unsigned char* base = reinterpret_cast<unsigned char*>(scratch);
  __nv_bfloat16* Wop = reinterpret_cast<__nv_bfloat16*>(base);
  float* dW_part = reinterpret_cast<float*>(base + sz.wop);
  float* dq_part = reinterpret_cast<float*>(base + sz.wop + sz.dw);
  const int Mp = padded_m(M), C = Mp / kC;
  const int tiles = (N + kTN - 1) / kTN;

  const long long wtotal = 2LL * D * Mp * Mp;
  prep_w_kernel<<<(int)std::min<long long>((wtotal + kThreads - 1) / kThreads,
                                           1 << 16),
                  kThreads, 0, st>>>(W, Wop, D, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dA_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dW_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return (int)err;

  // pass 1; grid.y is at most 65535: slices of L
  for (int l0 = 0; l0 < L; l0 += 65535) {
    dim3 grid(tiles, std::min(L - l0, 65535));
    dA_kernel<<<grid, kThreads, kSmem, st>>>(A, Wop, qmu, gqv, gss, gmn, dA,
                                             dq_part, l0, M, D, N, cov);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // pass 2
  const int S = n_slices(L, M, N, D);
  dW_kernel<<<dim3(S, C * C, D), kThreads, kSmem, st>>>(A, Wop, gqv, dW_part,
                                                        L, M, D, N, cov);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // pass 3
  const long long wout = (long long)D * M * M;
  reduce_dW_kernel<<<(int)std::min<long long>((wout + kThreads - 1) / kThreads,
                                              1 << 16),
                     kThreads, 0, st>>>(dW_part, S, D, M, dW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (mean) {
    reduce_dqmu_kernel<<<(M * D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        dq_part, L * tiles, M * D, dqmu);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* epilogue_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
