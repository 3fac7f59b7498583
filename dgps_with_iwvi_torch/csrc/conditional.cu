// The whole whitened conditional at true f32, one pass per tile of rows,
// with an optional reparameterized sample drawn in the kernel.
//
// Replaces the TPU kernels dgps_with_iwvi_tpu/ops/pallas/conditional.py
// `_fused_kernel` (l.51, variant "fused") and `_sample_kernel` (l.93,
// variant "sample"). For scaled inputs xs [N, d_in], zs [M, d_in], the
// kernel variance var, Linv [M, M], q_mu [M, D] and Lq [D, M, M]:
//
//   Kxz  = var exp(-max(|x|^2 - 2 x.z + |z|^2, 0) / 2)      [N, M]
//   A    = Kxz Linv^T                                       [N, M]
//   mean = A q_mu                                           [N, D]
//   var  = var - sum_m A^2 + sum_m (A tril(Lq_d))^2         [N, D]
//   samp = mean + sqrt(max(var, 0)) eps                     (variant sample)
//
// Every product is a true f32 FMA: the reference runs each dot at
// Precision.HIGHEST, and TF32 is none of the port's classes, so this is a
// CUDA-core kernel, not a tensor-core one. eps is Box-Muller on
// Philox4x32-10 (Salmon et al., SC'11) with key = the 64-bit seed and
// counter = (row, column, 0, 0): the stream does not depend on the tile.
// u1 = top 24 bits of word 0 * 2^-24 + 1e-12, u2 = of word 1, as the
// reference's `_sample_kernel` makes them.
//
// What bounds it on the H100: the D + 2 products against [M, M] matrices.
// At the serving inner layer (N = 819,200 rows, M = 128, D = 8) the work is
// 2 N M (d_in + M + D) + N M (M + 1) D = 1.4e11 f32 FLOP, 2.1 ms at 67
// TF/s, against 60 MB of inputs and outputs without the residuals:
// operation-bound. The q-variance against tril(Lq_d) is 80% of that work;
// multiplying the dense zero-padded Lq_d does 2 M^2 instead of M (M + 1)
// per row and d, 1.77x the bound's work at this shape. At the training
// shape (N = 10,240) a grid of row tiles alone gives 80 blocks of 128 rows
// for 132 SMs, each running the whole chain of D + 2 products.
//
// The design: a block of 256 threads owns TN = 128 rows and runs each
// product as an SGEMM main loop: each thread an 8 x 8 register tile (rows
// ty*8.., columns 16c + tx; TN = 64 and 4 x 8 where 128-row tiles would
// leave SMs without a block, as at D = 1, N = 10,240, or where M > 128
// needs separate Kxz and A buffers; TN = 32 where even those do not fit),
// the right-hand matrix copied 16 rows x 128 columns a stage by cp.async into a
// ring of 3 stages, one barrier per stage, the next stages in flight during
// the FMAs. The columns of a thread are 16 apart, so every thread has one
// column in each 16-column block: for tril(Lq_d), column block c is zero
// in the stages that lie wholly above the diagonal, and stage i runs (and
// copies) only blocks c <= i, uniformly over the block (no divergence):
// 36 of 64 (stage, block) pairs at M = 128. Kxz^T and then A^T live in one
// [k][row] buffer: A overwrites Kxz once its product is done (M <= 128),
// so a block needs ~107 KB and two fit on an SM. The q-variance's D
// products are split over a second grid dimension when the rows alone do
// not fill the card: each group recomputes the cheap Kxz -> A chain and
// runs its share of the d, and the count of groups minimizes waves x work
// per block, from N (3 groups at the training shape, 1 at serving). Every
// (row, d) output has one fixed order of sums, whatever the split, so
// results are bitwise repeatable; row sums reduce over the 16 threads of a
// row group with shuffles. The matrices are padded and laid out once per
// call by `prep_kernel` (Linv transposed, tril(Lq) applied, zeros to the
// chunk sizes) so that the main loop loads without bounds checks. Kxz and A
// go to device memory only when the caller asks for them (autograd's
// residuals), written by the first group only.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// The device functions live in a namespace named for the kernel, so
// that a profiler's rows name it (SYMBOLS in ops/hopper/cost.py).
namespace k5_conditional {

constexpr int kThreads = 256;
constexpr int kNC = 128;           // columns per output chunk
constexpr int kKC = 16;            // rows of the right-hand matrix per stage
constexpr int kStages = 3;         // cp.async ring
constexpr int kSmemMax = 232448;   // bytes a block may use on the H100

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Layout {  // offsets in floats into the scratch `prep_kernel` fills
  int kx, kp, np;  // rows of ZT, rows of LT / LQ, columns of all three
  size_t zt, lt, lq, qm, zz, total;
  __host__ __device__ Layout(int d_in, int M, int D) {
    kx = round_up(d_in, kKC);
    kp = round_up(M, kKC);
    np = round_up(M, kNC);
    zt = 0;                                 // [kx][np]  zs^T
    lt = zt + (size_t)kx * np;              // [kp][np]  Linv^T
    lq = lt + (size_t)kp * np;              // [D][kp][np] tril(Lq_d)
    qm = lq + (size_t)D * kp * np;          // [kp][D]   q_mu
    zz = qm + round_up(kp * D, 4);          // [np]      |z_j|^2
    total = zz + np;
  }
};

__global__ void prep_kernel(const float* __restrict__ zs,
                            const float* __restrict__ linv,
                            const float* __restrict__ qmu,
                            const float* __restrict__ lq, float* __restrict__ S,
                            int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  const size_t n_lq = (size_t)D * L.kp * L.np;
  const size_t total = (size_t)L.kx * L.np + (size_t)L.kp * L.np + n_lq +
                       (size_t)L.kp * D + L.np;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    size_t i = idx;
    if (i < (size_t)L.kx * L.np) {
      const int k = (int)(i / L.np), j = (int)(i % L.np);
      S[L.zt + i] = (k < d_in && j < M) ? zs[(size_t)j * d_in + k] : 0.0f;
      continue;
    }
    i -= (size_t)L.kx * L.np;
    if (i < (size_t)L.kp * L.np) {
      const int k = (int)(i / L.np), j = (int)(i % L.np);
      S[L.lt + i] = (k < M && j < M) ? linv[(size_t)j * M + k] : 0.0f;
      continue;
    }
    i -= (size_t)L.kp * L.np;
    if (i < n_lq) {
      const int j = (int)(i % L.np);
      const size_t dk = i / L.np;
      const int k = (int)(dk % L.kp), d = (int)(dk / L.kp);
      S[L.lq + i] = (k < M && j <= k) ? lq[((size_t)d * M + k) * M + j] : 0.0f;
      continue;
    }
    i -= n_lq;
    if (i < (size_t)L.kp * D) {
      const int k = (int)(i / D), d = (int)(i % D);
      S[L.qm + i] = k < M ? qmu[(size_t)k * D + d] : 0.0f;
      continue;
    }
    i -= (size_t)L.kp * D;
    const int j = (int)i;
    float s = 0.0f;
    if (j < M)
      for (int k = 0; k < d_in; ++k) {
        const float z = zs[(size_t)j * d_in + k];
        s = fmaf(z, z, s);
      }
    S[L.zz + j] = s;
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Box-Muller normal of (row, column) under the 64-bit seed.
__device__ __forceinline__ float philox_normal(uint64_t seed, uint32_t row,
                                               uint32_t col) {
  const uint4 b = philox4x32_10(make_uint4(row, col, 0u, 0u), (uint32_t)seed,
                                (uint32_t)(seed >> 32));
  const float u1 = (float)(b.x >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  const float u2 = (float)(b.y >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cp.async of rows k0..k0+15, columns j0..j0+ncols-1 (ncols a multiple of 4)
// of B (row stride ldb) into a ring slot [kKC][kNC].
__device__ __forceinline__ void issue_stage(float* slot, const float* B,
                                            int ldb, int k0, int j0,
                                            int ncols) {
  const int c4s = ncols / 4;
  for (int v = threadIdx.x; v < kKC * c4s; v += kThreads) {
    const int r = v / c4s, c4 = v % c4s;
    cp_async16(slot + r * kNC + c4 * 4, B + (size_t)(k0 + r) * ldb + j0 + c4 * 4);
  }
}

// acc[i][c] += sum_{kk < 16} In[kk][ty RPT + i] * Bs[kk][16 c + tx] for the
// first C column blocks; In: [16][ldt] rows of the transposed input.
template <int RPT, int C>
__device__ __forceinline__ void stage_fma(const float* In, int ldt,
                                          const float* Bs,
                                          float (&acc)[RPT][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) {
    float a[RPT];
    const float* in = In + kk * ldt + ty * RPT;
    if constexpr (RPT % 4 == 0) {
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(in + i);
        a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RPT; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(in + i);
        a[i] = v.x, a[i + 1] = v.y;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float b = Bs[kk * kNC + c * 16 + tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
    }
  }
}

// acc[i][c] = sum_k InT[k][ty RPT + i] * B[k][j0 + 16 c + tx] over k < K
// (InT: shared, [K][ldt]; B: device memory, [K][ldb], K a multiple of kKC).
// kTril: B is tril(.) (zero for k < j): the loop starts at k = j0 and stage
// i runs and copies column blocks c <= i only. Starts with a barrier, so
// the caller's writes to InT are visible and the ring is free.
template <int RPT, bool kTril>
__device__ __forceinline__ void product(const float* InT, int ldt, int K,
                                     const float* __restrict__ B, int ldb,
                                     int j0, float* ring,
                                     float (&acc)[RPT][8]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  __syncthreads();
  const int s0 = kTril ? j0 / kKC : 0;
  const int ns = K / kKC - s0;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < ns)
      issue_stage(ring + p * kKC * kNC, B, ldb, (s0 + p) * kKC, j0,
                  kTril ? min(kNC, 16 * (p + 1)) : kNC);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; every thread is done with stage i-1
    const int p = i + kStages - 1;
    if (p < ns)
      issue_stage(ring + (p % kStages) * kKC * kNC, B, ldb, (s0 + p) * kKC,
                  j0, kTril ? min(kNC, 16 * (p + 1)) : kNC);
    cp_async_commit();
    const float* bs = ring + (i % kStages) * kKC * kNC;
    const float* in = InT + (size_t)(s0 + i) * kKC * ldt;
    switch (kTril ? min(i, 7) + 1 : 8) {
      case 1: stage_fma<RPT, 1>(in, ldt, bs, acc); break;
      case 2: stage_fma<RPT, 2>(in, ldt, bs, acc); break;
      case 3: stage_fma<RPT, 3>(in, ldt, bs, acc); break;
      case 4: stage_fma<RPT, 4>(in, ldt, bs, acc); break;
      case 5: stage_fma<RPT, 5>(in, ldt, bs, acc); break;
      case 6: stage_fma<RPT, 6>(in, ldt, bs, acc); break;
      case 7: stage_fma<RPT, 7>(in, ldt, bs, acc); break;
      default: stage_fma<RPT, 8>(in, ldt, bs, acc); break;
    }
  }
}

// Sum over the 16 threads of a row group (one half of a warp).
__device__ __forceinline__ float row_group_sum(float s) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__host__ __device__ inline size_t smem_floats(int rpt, const Layout& L,
                                              int dpg) {
  const int tn = 16 * rpt, ldt = tn + 4;
  const int bufs = L.np == kNC ? 1 : 2;  // A overwrites Kxz at M <= 128
  return (size_t)kStages * kKC * kNC + (size_t)(L.kx + bufs * L.kp) * ldt +
         tn + 2 * (size_t)tn * dpg;
}

// Grid (row tiles, groups of d): block (b, g) owns rows b TN.. and the
// q-variance of d in [g dpg, min(D, (g + 1) dpg)).
template <int RPT>
__global__ void __launch_bounds__(kThreads, RPT == 8 ? 2 : RPT == 4 ? 3 : 1)
conditional_kernel(const float* __restrict__ xs, const float* __restrict__ var_p,
                   const float* __restrict__ S, const int64_t* __restrict__ seed_p,
                   float* __restrict__ mean_o, float* __restrict__ var_o,
                   float* __restrict__ samp_o, float* __restrict__ kxz_o,
                   float* __restrict__ a_o, int N, int d_in, int M, int D,
                   int dpg) {
  constexpr int TN = 16 * RPT;
  constexpr int LDT = TN + 4;
  const Layout L(d_in, M, D);
  const bool inplace = L.np == kNC;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                // [kStages][kKC][kNC]
  float* XsT = ring + kStages * kKC * kNC;           // [kx][LDT]
  float* KsT = XsT + L.kx * LDT;                     // [kp][LDT] Kxz^T
  float* AsT = inplace ? KsT : KsT + L.kp * LDT;     // [kp][LDT] A^T
  float* XX = AsT + L.kp * LDT;                      // [TN] |x|^2, then var - sum A^2
  float* QV = XX + TN;                               // [TN][dpg] q-variance
  float* MN = QV + TN * dpg;                         // [TN][dpg] mean

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TN;
  const int d0 = blockIdx.y * dpg, nd = min(D, d0 + dpg) - d0;
  float* kxz_w = blockIdx.y == 0 ? kxz_o : nullptr;  // one group writes them
  float* a_w = blockIdx.y == 0 ? a_o : nullptr;
  const float var = *var_p;

  for (int idx = tid; idx < L.kx * TN; idx += kThreads) {
    const int k = idx / TN, r = idx % TN;
    XsT[k * LDT + r] =
        (k < d_in && n0 + r < N) ? xs[(size_t)(n0 + r) * d_in + k] : 0.0f;
  }
  __syncthreads();
  for (int r = tid; r < TN; r += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < d_in; ++k) s = fmaf(XsT[k * LDT + r], XsT[k * LDT + r], s);
    XX[r] = s;
  }

  float acc[RPT][8];

  // ---- Kxz = var exp(-max(xx - 2 x.z + zz, 0) / 2), [kp][rows] ------------
  for (int j0 = 0; j0 < L.np; j0 += kNC) {
    product<RPT, false>(XsT, LDT, L.kx, S + L.zt, L.np, j0, ring, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, n = n0 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + c * 16 + tx;
        if (j >= L.kp) continue;
        const float d2 = fmaxf(XX[r] - 2.0f * acc[i][c] + S[L.zz + j], 0.0f);
        const float k = j < M ? var * expf(-0.5f * d2) : 0.0f;
        KsT[j * LDT + r] = k;
        if (kxz_w != nullptr && n < N && j < M) kxz_w[(size_t)n * M + j] = k;
      }
    }
  }

  // ---- A = Kxz Linv^T, and var - sum_m A^2 --------------------------------
  float ss[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) ss[i] = 0.0f;
  for (int j0 = 0; j0 < L.np; j0 += kNC) {
    product<RPT, false>(KsT, LDT, L.kp, S + L.lt, L.np, j0, ring, acc);
    if (inplace) __syncthreads();  // every thread is done reading Kxz^T
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, n = n0 + r;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + c * 16 + tx;
        const float a = acc[i][c];  // zero past M: Linv^T is zero-padded
        s = fmaf(a, a, s);
        if (j < L.kp) AsT[j * LDT + r] = a;
        if (a_w != nullptr && n < N && j < M) a_w[(size_t)n * M + j] = a;
      }
      ss[i] += row_group_sum(s);
    }
  }
  __syncthreads();  // AsT is read by other threads below
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < RPT; ++i) XX[ty * RPT + i] = var - ss[i];

  // ---- mean = A q_mu for this group's d: thread (ty, tx) takes rows ty RPT..
  // and d = d0 + dc + tx, the RPT sums independent of each other -----------
  const float* QM = S + L.qm;
  for (int dc = 0; dc < nd; dc += 16) {
    const int dd = dc + tx;
    if (dd < nd) {
      float m[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) m[i] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < M; ++k) {
        const float q = __ldg(QM + k * D + d0 + dd);
        const float* in = AsT + k * LDT + ty * RPT;
#pragma unroll
        for (int i = 0; i < RPT; ++i) m[i] = fmaf(in[i], q, m[i]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) MN[(ty * RPT + i) * dpg + dd] = m[i];
    }
  }

  // ---- q-variance: sum_j (A tril(Lq_d))[., j]^2 ----------------------------
  for (int dd = 0; dd < nd; ++dd) {
    float qv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qv[i] = 0.0f;
    const float* lq = S + L.lq + (size_t)(d0 + dd) * L.kp * L.np;
    for (int j0 = 0; j0 < L.np; j0 += kNC) {
      product<RPT, true>(AsT, LDT, L.kp, lq, L.np, j0, ring, acc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) s = fmaf(acc[i][c], acc[i][c], s);
        qv[i] += row_group_sum(s);
      }
    }
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < RPT; ++i) QV[(ty * RPT + i) * dpg + dd] = qv[i];
  }
  __syncthreads();

  // ---- outputs: mean, var = (var - sum A^2) + qv, the sample ---------------
  const uint64_t seed = seed_p != nullptr ? (uint64_t)*seed_p : 0;
  for (int idx = tid; idx < TN * nd; idx += kThreads) {
    const int r = idx / nd, dd = idx % nd, n = n0 + r, d = d0 + dd;
    if (n >= N) continue;
    const float m = MN[r * dpg + dd];
    const float v = XX[r] + QV[r * dpg + dd];
    const size_t o = (size_t)n * D + d;
    mean_o[o] = m;
    var_o[o] = v;
    if (samp_o != nullptr)
      samp_o[o] = m + sqrtf(fmaxf(v, 0.0f)) *
                          philox_normal(seed, (uint32_t)n, (uint32_t)d);
  }
}

// The count of d per group: the fewest waves x work per block, with the
// chain to A (gram and Linv products) recomputed in every group.
int d_per_group(int tiles, int slots, const Layout& L, int D) {
  const double chain = (double)L.kx * L.np + (double)L.kp * L.np;
  const double per_d = 0.5 * L.kp * L.np + 8.0 * L.kp;
  int best = D;
  double best_cost = 0.0;
  for (int dpg = D; dpg >= 1; --dpg) {
    const int groups = (D + dpg - 1) / dpg;
    const long long waves = ((long long)tiles * groups + slots - 1) / slots;
    const double cost = (double)waves * (chain + dpg * per_d);
    if (dpg == D || cost < best_cost) best = dpg, best_cost = cost;
  }
  return best;
}

// The grid of conditional_kernel<RPT> for N rows: (row tiles, groups of
// d), with the d per group; and the card's SM count. Sets the kernel's
// shared memory attribute and queries the block slots once per (device,
// size). static: its caches stay this library's own (see
// serve_cond.cu's launch_chain).
template <int RPT>
static cudaError_t plan(const Layout& L, int N, int D, int device, dim3* grid,
                        int* dpg, int* sms) {
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int slots = 1, sm_count = 1;
  const size_t smax = sizeof(float) * smem_floats(RPT, L, D);
  if (device != cached_device || smax != cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        conditional_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smax);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conditional_kernel<RPT>, kThreads, smax);
    if (err != cudaSuccess) return err;
    slots = std::max(1, sm_count * per_sm);
    cached_device = device;
    cached_smem = smax;
  }
  const int tiles = (N + 16 * RPT - 1) / (16 * RPT);
  *dpg = d_per_group(tiles, slots, L, D);
  *grid = dim3(tiles, (D + *dpg - 1) / *dpg);
  *sms = sm_count;
  return cudaSuccess;
}

template <int RPT>
cudaError_t launch(const float* xs, const float* var, const float* S,
                   const int64_t* seed, float* mean, float* varo, float* samp,
                   float* kxz, float* a, int N, int d_in, int M, int D,
                   dim3 grid, int dpg, cudaStream_t s) {
  const Layout L(d_in, M, D);
  conditional_kernel<RPT><<<grid, kThreads,
                            sizeof(float) * smem_floats(RPT, L, dpg), s>>>(
      xs, var, S, seed, mean, varo, samp, kxz, a, N, d_in, M, D, dpg);
  return cudaGetLastError();
}

}  // namespace k5_conditional

using namespace k5_conditional;

extern "C" {

// Bytes of the scratch `conditional_launch` takes.
long long conditional_scratch_bytes(int d_in, int M, int D) {
  return (long long)(Layout(d_in, M, D).total * sizeof(float));
}

// xs [N, d_in], zs [M, d_in], var [1], linv [M, M], qmu [M, D], lq [D, M, M]
// (f32, contiguous, on the device); seed: one int64 on the device, or null
// for the fused variant (then samp is null too). Writes mean, varo [N, D],
// samp [N, D] with a seed, and kxz, a [N, M] where not null. Returns the
// CUDA error code (0 on success); cudaErrorInvalidValue where M is too
// large for a block's shared memory.
int conditional_launch(const float* xs, const float* zs, const float* var,
                       const float* linv, const float* qmu, const float* lq,
                       const int64_t* seed, float* mean, float* varo,
                       float* samp, float* kxz, float* a, void* scratch, int N,
                       int d_in, int M, int D, int device, void* stream) {
  if (N <= 0 || d_in <= 0 || M <= 0 || D <= 0 || (seed == nullptr) != (samp == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* S = reinterpret_cast<float*>(scratch);
  const Layout L(d_in, M, D);
  const int blocks =
      (int)std::min<size_t>((L.total + kThreads - 1) / kThreads, 1 << 16);
  prep_kernel<<<blocks, kThreads, 0, s>>>(zs, linv, qmu, lq, S, d_in, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 128-row tiles where they give every SM a block, else 64 (Adam-only
  // training: D = 1, N = 10,240); 32 where M is too large for either
  dim3 grid;
  int dpg = 0, sms = 0;
  const auto fits = [&](int rpt) {
    return sizeof(float) * smem_floats(rpt, L, D) <= (size_t)kSmemMax;
  };
  if (fits(8)) {
    err = plan<8>(L, N, D, device, &grid, &dpg, &sms);
    if (err != cudaSuccess) return (int)err;
    if ((int)(grid.x * grid.y) >= sms || !fits(4))
      return (int)launch<8>(xs, var, S, seed, mean, varo, samp, kxz, a, N,
                            d_in, M, D, grid, dpg, s);
  }
  if (fits(4)) {
    err = plan<4>(L, N, D, device, &grid, &dpg, &sms);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<4>(xs, var, S, seed, mean, varo, samp, kxz, a, N,
                          d_in, M, D, grid, dpg, s);
  }
  if (fits(2)) {
    err = plan<2>(L, N, D, device, &grid, &dpg, &sms);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<2>(xs, var, S, seed, mean, varo, samp, kxz, a, N,
                          d_in, M, D, grid, dpg, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* conditional_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
