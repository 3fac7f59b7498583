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
// What bounds it on the H100: the D+2 products against [M, M] matrices.
// At the serving inner layer (N = 819,200 rows, M = 128, D = 8) that is
// 2 N M (d_in + M + D + D M) = 2.5e11 f32 FLOP, 3.7 ms at 67 TF/s, against
// 60 MB of inputs and outputs without the residuals: operation-bound. The
// design: a block owns TN rows (64, or 16 when M is too large for shared
// memory) against all M. It keeps Kxz and A for its rows in shared memory,
// transposed ([column][row]), and runs each product as a register-tiled
// SGEMM: 256 threads, each RPT rows x 8 columns of a 128-column chunk, the
// right-hand matrix streamed through shared memory 16 rows at a time. Each
// thread's columns are 4 + 4 apart by 64, so a warp reads shared memory in
// full 16-byte vectors without bank conflicts. Row sums (sum A^2 and the
// q-variance) reduce over the 16 threads of a row group with shuffles, in
// a fixed order. The matrices are padded and laid out once per call by
// `prep_kernel` (Linv transposed, tril(Lq) applied, zeros to the chunk
// sizes) so that the main loop loads without bounds checks. Kxz and A go
// to device memory only when the caller asks for them (autograd's
// residuals). Later work: a tensor-core route needs a 3xTF32 or bf16x6
// split to stay at f32, and Kxz need not be kept once A is formed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kNC = 128;           // columns per output chunk
constexpr int kKC = 16;            // rows of the right-hand matrix per stage
constexpr int kLDB = kNC + 4;      // f32 row stride of the staged chunk
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

// acc[i][c] = sum_{k < K} InT[k][ty RPT + i] * B[k][j0 + col(c)] for this
// thread's rows and columns col(c) = tx*4 + c (c < 4), 64 + tx*4 + c - 4.
// InT: shared, [K][ldt]; B: device memory, [K][ldb], K a multiple of kKC.
// Starts with a barrier, so the caller's writes to InT are visible.
template <int RPT>
__device__ __forceinline__ void chunk_product(const float* InT, int ldt, int K,
                                              const float* __restrict__ B,
                                              int ldb, int j0, float* Bs,
                                              float (&acc)[RPT][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int v = tid; v < kKC * (kNC / 4); v += kThreads) {
      const int r = v / (kNC / 4), c4 = v % (kNC / 4);
      *reinterpret_cast<float4*>(Bs + r * kLDB + c4 * 4) =
          __ldg(reinterpret_cast<const float4*>(B + (size_t)(k0 + r) * ldb +
                                                j0 + c4 * 4));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float a[RPT];
      const float* in = InT + (k0 + kk) * ldt + ty * RPT;
      if constexpr (RPT == 4) {
        const float4 v = *reinterpret_cast<const float4*>(in);
        a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = in[i];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLDB + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * kLDB + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }
}

__device__ __forceinline__ int col_of(int tx, int c) {
  return c < 4 ? tx * 4 + c : 64 + tx * 4 + (c - 4);
}

// Sum over the 16 threads of a row group (one half of a warp).
__device__ __forceinline__ float row_group_sum(float s) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
conditional_kernel(const float* __restrict__ xs, const float* __restrict__ var_p,
                   const float* __restrict__ S, const int64_t* __restrict__ seed_p,
                   float* __restrict__ mean_o, float* __restrict__ var_o,
                   float* __restrict__ samp_o, float* __restrict__ kxz_o,
                   float* __restrict__ a_o, int N, int d_in, int M, int D) {
  constexpr int TN = 16 * RPT;
  constexpr int LDT = TN + 4;
  const Layout L(d_in, M, D);
  extern __shared__ __align__(16) float smem[];
  float* XsT = smem;                       // [kx][LDT]
  float* KsT = XsT + L.kx * LDT;           // [kp][LDT]
  float* AsT = KsT + L.kp * LDT;           // [kp][LDT]
  float* Bs = AsT + L.kp * LDT;            // [kKC][kLDB]
  float* XX = Bs + kKC * kLDB;             // [TN] |x|^2, then var - sum A^2
  float* QV = XX + TN;                     // [TN][D] q-variance
  float* MN = QV + TN * D;                 // [TN][D] mean

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TN;
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
  // ---- Kxz = var exp(-max(xx - 2 x.z + zz, 0) / 2), [rows][kp] ------------
  for (int j0 = 0; j0 < L.np; j0 += kNC) {
    chunk_product<RPT>(XsT, LDT, L.kx, S + L.zt, L.np, j0, Bs, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, n = n0 + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + col_of(tx, c);
        if (j >= L.kp) continue;
        const float d2 = fmaxf(XX[r] - 2.0f * acc[i][c] + S[L.zz + j], 0.0f);
        const float k = j < M ? var * expf(-0.5f * d2) : 0.0f;
        KsT[j * LDT + r] = k;
        if (kxz_o != nullptr && n < N && j < M) kxz_o[(size_t)n * M + j] = k;
      }
    }
  }

  // ---- A = Kxz Linv^T, and var - sum_m A^2 --------------------------------
  float ss[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) ss[i] = 0.0f;
  for (int j0 = 0; j0 < L.np; j0 += kNC) {
    chunk_product<RPT>(KsT, LDT, L.kp, S + L.lt, L.np, j0, Bs, acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, n = n0 + r;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + col_of(tx, c);
        const float a = acc[i][c];  // zero past M: Linv^T is zero-padded
        s = fmaf(a, a, s);
        if (j < L.kp) AsT[j * LDT + r] = a;
        if (a_o != nullptr && n < N && j < M) a_o[(size_t)n * M + j] = a;
      }
      ss[i] += row_group_sum(s);
    }
  }
  __syncthreads();  // XX and AsT are read by other threads below
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < RPT; ++i) XX[ty * RPT + i] = var - ss[i];

  // ---- mean = A q_mu, one (row, d) per thread ------------------------------
  const float* QM = S + L.qm;
  for (int idx = tid; idx < TN * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float s = 0.0f;
    for (int k = 0; k < M; ++k) s = fmaf(AsT[k * LDT + r], QM[k * D + d], s);
    MN[idx] = s;
  }

  // ---- q-variance: sum_j (A tril(Lq_d))[., j]^2 ----------------------------
  for (int d = 0; d < D; ++d) {
    float qv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qv[i] = 0.0f;
    for (int j0 = 0; j0 < L.np; j0 += kNC) {
      chunk_product<RPT>(AsT, LDT, L.kp, S + L.lq + (size_t)d * L.kp * L.np,
                         L.np, j0, Bs, acc);
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
      for (int i = 0; i < RPT; ++i) QV[(ty * RPT + i) * D + d] = qv[i];
  }
  __syncthreads();

  // ---- outputs: mean, var = (var - sum A^2) + qv, the sample ---------------
  const uint64_t seed = seed_p != nullptr ? (uint64_t)*seed_p : 0;
  for (int idx = tid; idx < TN * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, n = n0 + r;
    if (n >= N) continue;
    const float v = XX[r] + QV[idx];
    const size_t o = (size_t)n * D + d;
    mean_o[o] = MN[idx];
    var_o[o] = v;
    if (samp_o != nullptr)
      samp_o[o] = MN[idx] + sqrtf(fmaxf(v, 0.0f)) *
                                philox_normal(seed, (uint32_t)n, (uint32_t)d);
  }
}

size_t smem_bytes(int rpt, int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  const int tn = 16 * rpt, ldt = tn + 4;
  return sizeof(float) * ((size_t)(L.kx + 2 * L.kp) * ldt + kKC * kLDB + tn +
                          2 * (size_t)tn * D);
}

template <int RPT>
cudaError_t launch(const float* xs, const float* var, const float* S,
                   const int64_t* seed, float* mean, float* varo, float* samp,
                   float* kxz, float* a, int N, int d_in, int M, int D,
                   size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conditional_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + 16 * RPT - 1) / (16 * RPT);
  conditional_kernel<RPT><<<blocks, kThreads, smem, s>>>(
      xs, var, S, seed, mean, varo, samp, kxz, a, N, d_in, M, D);
  return cudaGetLastError();
}

}  // namespace

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
  const size_t s4 = smem_bytes(4, d_in, M, D), s1 = smem_bytes(1, d_in, M, D);
  if (s4 <= (size_t)kSmemMax)
    return (int)launch<4>(xs, var, S, seed, mean, varo, samp, kxz, a, N, d_in,
                          M, D, s4, s);
  if (s1 <= (size_t)kSmemMax)
    return (int)launch<1>(xs, var, S, seed, mean, varo, samp, kxz, a, N, d_in,
                          M, D, s1, s);
  return (int)cudaErrorInvalidValue;
}

const char* conditional_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
