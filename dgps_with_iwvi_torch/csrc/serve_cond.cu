// The whole whitened conditional for inference, at the bf16x3 / bf16
// classes, with an optional sample; nothing of size [rows, M] leaves the SM.
//
// Replaces the TPU kernel dgps_with_iwvi_tpu/ops/pallas/serve_cond.py
// `_infer_kernel` (l.73). For scaled inputs xs [N, d_in], zs [M, d_in], the
// kernel variance var, Linv [M, M], q_mu [M, D], Lq [D, M, M] and, for the
// sample, eps [N, D] from the caller:
//
//   Kxz  = var exp(-max(|x|^2 - 2 dot3(x, z^T) + |z|^2, 0) / 2)
//   A    = dot3(Kxz, Linv^T)
//   mean = dot3(A, q_mu)
//   qv_d = sum_j (bf16(A) bf16(tril(Lq_d)))[., j]^2        (f32 accumulation)
//   var  = max(var - sum_m A^2, 0) + qv
//   samp = mean + sqrt(max(var, 1e-12)) eps
//
// dot3 is the reference's `_dot3` (serve_cond.py:59-70): both operands split
// into bf16 hi and lo, hi*hi + hi*lo + lo*hi accumulated in f32, lo*lo
// dropped. Here every product is mma.sync m16n8k16 with bf16 fragments and
// f32 accumulators, as in csrc/epilogue.cu; the three passes of a dot3 add
// into one accumulator.
//
// What bounds it on the H100: at the serving inner layer (N = 819,200, M =
// 128, d_in = 9, D = 8) the products are 2 N M (3 d_in + 3 M + 3 D + D M)
// = 3.1e11 bf16 FLOP, 0.31 ms at 989 TF/s, against 86 MB of inputs and
// outputs (0.03 ms): operation-bound. The design: each warp owns 16 rows
// against all M and runs the chain alone, with no barrier: its rows' x,
// Kxz and A stay in shared memory in f32, and the mma A-fragments (hi and
// lo) are cut from them as they are read; row stride = 8 mod 32 floats,
// so the 8-byte fragment reads are free of bank conflicts. The right-hand
// matrices are split and laid out once per call by `prep_kernel` ([n][k]
// bf16, hi and lo, zero-padded), and read as fragments straight from
// device memory: 64 KB per matrix at M = 128, held in L1 and L2 for all
// warps. Row sums reduce over the 4 lanes of a quad with shuffles. A block
// has up to 4 warps, as many as shared memory allows at this M. Later work:
// wgmma, the B fragments in shared memory, and the gram fused into the A
// product so that Kxz is never stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 16;           // rows per warp
constexpr int kMaxWarps = 4;
constexpr int kNT = 16;             // n8 tiles per output chunk (128 columns)
constexpr int kSmemMax = 232448;    // bytes a block may use on the H100

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// row stride in floats of a warp's [16][k] buffer: >= k, = 8 mod 32
__host__ __device__ constexpr int stride_of(int k) { return round_up(k, 32) + 8; }

struct Layout {  // bf16 operands [n][k] in the scratch, then |z|^2 in f32
  int kx, kp, mn, dn;
  size_t zb_h, zb_l, lb_h, lb_l, qb_h, qb_l, lqb, end_bf16, zz_bytes, total;
  __host__ __device__ Layout(int d_in, int M, int D) {
    kx = round_up(d_in, 16);
    kp = round_up(M, 8 * kNT);  // whole output chunks: no partial tile loop
    mn = kp;
    dn = round_up(D, 8);
    zb_h = 0;                                  // [mn][kx]   zs
    zb_l = zb_h + (size_t)mn * kx;
    lb_h = zb_l + (size_t)mn * kx;             // [mn][kp]   Linv
    lb_l = lb_h + (size_t)mn * kp;
    qb_h = lb_l + (size_t)mn * kp;             // [dn][kp]   q_mu^T
    qb_l = qb_h + (size_t)dn * kp;
    lqb = qb_l + (size_t)dn * kp;              // [D][mn][kp] tril(Lq_d)^T
    end_bf16 = lqb + (size_t)D * mn * kp;
    zz_bytes = (end_bf16 * 2 + 15) / 16 * 16;
    total = zz_bytes + (size_t)mn * sizeof(float);
  }
};

__device__ __forceinline__ void split(float v, __nv_bfloat16* h,
                                      __nv_bfloat16* l) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  *h = hi;
  if (l != nullptr) *l = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__global__ void prep_kernel(const float* __restrict__ zs,
                            const float* __restrict__ linv,
                            const float* __restrict__ qmu,
                            const float* __restrict__ lq, void* scratch,
                            int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  __nv_bfloat16* B = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* zz = reinterpret_cast<float*>(reinterpret_cast<char*>(scratch) +
                                       L.zz_bytes);
  const size_t n_z = (size_t)L.mn * L.kx, n_l = (size_t)L.mn * L.kp,
               n_q = (size_t)L.dn * L.kp, n_lq = (size_t)D * L.mn * L.kp;
  const size_t total = n_z + n_l + n_q + n_lq + L.mn;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    size_t i = idx;
    if (i < n_z) {  // B[k][j] = zs[j][k]
      const int j = (int)(i / L.kx), k = (int)(i % L.kx);
      split(j < M && k < d_in ? zs[(size_t)j * d_in + k] : 0.0f,
            B + L.zb_h + i, B + L.zb_l + i);
      continue;
    }
    i -= n_z;
    if (i < n_l) {  // B[k][j] = Linv^T[k][j] = Linv[j][k]
      const int j = (int)(i / L.kp), k = (int)(i % L.kp);
      split(j < M && k < M ? linv[(size_t)j * M + k] : 0.0f, B + L.lb_h + i,
            B + L.lb_l + i);
      continue;
    }
    i -= n_l;
    if (i < n_q) {  // B[k][d] = q_mu[k][d]
      const int d = (int)(i / L.kp), k = (int)(i % L.kp);
      split(d < D && k < M ? qmu[(size_t)k * D + d] : 0.0f, B + L.qb_h + i,
            B + L.qb_l + i);
      continue;
    }
    i -= n_q;
    if (i < n_lq) {  // B[k][j] = tril(Lq_d)[k][j]; one bf16 pass
      const int k = (int)(i % L.kp);
      const size_t dj = i / L.kp;
      const int j = (int)(dj % L.mn), d = (int)(dj / L.mn);
      split(j < M && k < M && j <= k ? lq[((size_t)d * M + k) * M + j] : 0.0f,
            B + L.lqb + i, nullptr);
      continue;
    }
    i -= n_lq;
    const int j = (int)i;
    float s = 0.0f;
    if (j < M)
      for (int k = 0; k < d_in; ++k) {
        const float z = zs[(size_t)j * d_in + k];
        s = fmaf(z, z, s);
      }
    zz[j] = s;
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (n8 tile nt of columns n0 + 8 nt ..) = In[16 rows][0, K) @ B[0,
// K)[n0 ..] for nt < NT. In: the warp's f32 rows in shared memory (stride
// ldi, zero past the real K); Bh / Bl: [n][K] bf16 in device memory.
// kThree: dot3 (hi*hi + hi*lo + lo*hi); else one pass on the hi halves.
// NT is fixed when compiling, so the B loads of a k step are independent of
// any bound and can be issued ahead of their products.
template <bool kThree, int NT>
__device__ __forceinline__ void warp_product(const float* In, int ldi, int K,
                                             const __nv_bfloat16* __restrict__ Bh,
                                             const __nv_bfloat16* __restrict__ Bl,
                                             int n0, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    // A fragment (row-major 16 x 16): rows g / g+8, columns 2t4.. / +8..
    const float* p0 = In + g * ldi + k0 + 2 * t4;
    const float* p8 = p0 + 8 * ldi;
    const float2 x[4] = {*reinterpret_cast<const float2*>(p0),
                         *reinterpret_cast<const float2*>(p8),
                         *reinterpret_cast<const float2*>(p0 + 8),
                         *reinterpret_cast<const float2*>(p8 + 8)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[i].x, x[i].y);
      ah[i] = as_u32(h);
      if (kThree)
        al[i] = as_u32(__floats2bfloat162_rn(x[i].x - __low2float(h),
                                             x[i].y - __high2float(h)));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragment ("col", K x 8): column g, rows 2t4.. and 2t4+8..
      const size_t off = (size_t)(n0 + nt * 8 + g) * K + k0 + 2 * t4;
      const uint32_t bh0 = __ldg(reinterpret_cast<const unsigned int*>(Bh + off));
      const uint32_t bh1 = __ldg(reinterpret_cast<const unsigned int*>(Bh + off + 8));
      mma_bf16(acc[nt], ah, bh0, bh1);
      if (kThree) {
        const uint32_t bl0 = __ldg(reinterpret_cast<const unsigned int*>(Bl + off));
        const uint32_t bl1 =
            __ldg(reinterpret_cast<const unsigned int*>(Bl + off + 8));
        mma_bf16(acc[nt], ah, bl0, bl1);
        mma_bf16(acc[nt], al, bh0, bh1);
      }
    }
  }
}

// Sum over the 4 lanes of a quad (the lanes that share rows g and g+8).
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

__host__ __device__ inline int warp_floats(int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  return kRows * (stride_of(L.kx) + 2 * stride_of(L.kp) + 2 * D + 2);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
serve_cond_kernel(const float* __restrict__ xs, const float* __restrict__ var_p,
                  const void* __restrict__ scratch, const float* __restrict__ eps,
                  float* __restrict__ mean_o, float* __restrict__ var_o,
                  float* __restrict__ samp_o, int N, int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  const __nv_bfloat16* B = reinterpret_cast<const __nv_bfloat16*>(scratch);
  const float* zz = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(scratch) + L.zz_bytes);
  const int ldx = stride_of(L.kx), ld = stride_of(L.kp);
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* Xs = smem + (size_t)warp * warp_floats(d_in, M, D);  // [16][ldx]
  float* Ks = Xs + kRows * ldx;                               // [16][ld]
  float* As = Ks + kRows * ld;                                // [16][ld]
  float* MN = As + kRows * ld;                                // [16][D]
  float* VQ = MN + kRows * D;                                 // [16][D]
  float* XX = VQ + kRows * D;                                 // [16]
  float* SS = XX + kRows;                                     // [16]
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kRows;
  if (row0 >= N) return;  // whole warps only: no barrier follows
  const float var = *var_p;

  for (int idx = lane; idx < kRows * L.kx; idx += 32) {
    const int r = idx / L.kx, k = idx % L.kx;
    Xs[r * ldx + k] =
        (k < d_in && row0 + r < N) ? xs[(size_t)(row0 + r) * d_in + k] : 0.0f;
  }
  __syncwarp();
  if (lane < kRows) {
    float s = 0.0f;
    for (int k = 0; k < d_in; ++k) s = fmaf(Xs[lane * ldx + k], Xs[lane * ldx + k], s);
    XX[lane] = s;
  }
  __syncwarp();

  float acc[kNT][4];
  const int rows[2] = {g, g + 8};
  // ---- Kxz = var exp(-max(xx - 2 dot3(x, z) + zz, 0) / 2) ------------------
  for (int n0 = 0; n0 < L.mn; n0 += 8 * kNT) {
    warp_product<true, kNT>(Xs, ldx, L.kx, B + L.zb_h, B + L.zb_l, n0, acc);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rows[r >> 1], j = n0 + nt * 8 + 2 * t4 + (r & 1);
        const float d2 = fmaxf(XX[row] - 2.0f * acc[nt][r] + zz[j], 0.0f);
        Ks[row * ld + j] = j < M ? var * expf(-0.5f * d2) : 0.0f;
      }
  }
  __syncwarp();

  // ---- A = dot3(Kxz, Linv^T); sum_m A^2 -------------------------------------
  float ss[2] = {0.0f, 0.0f};
  for (int n0 = 0; n0 < L.mn; n0 += 8 * kNT) {
    warp_product<true, kNT>(Ks, ld, L.kp, B + L.lb_h, B + L.lb_l, n0, acc);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rows[r >> 1], j = n0 + nt * 8 + 2 * t4 + (r & 1);
        const float a = acc[nt][r];  // zero past M: Linv is zero-padded
        As[row * ld + j] = a;
        ss[r >> 1] = fmaf(a, a, ss[r >> 1]);
      }
  }
  ss[0] = quad_sum(ss[0]);
  ss[1] = quad_sum(ss[1]);
  if (t4 == 0) {
    SS[g] = ss[0];
    SS[g + 8] = ss[1];
  }
  __syncwarp();

  // ---- mean = dot3(A, q_mu), one n8 tile of outputs at a time --------------
  for (int n0 = 0; n0 < L.dn; n0 += 8) {
    float am[1][4];
    warp_product<true, 1>(As, ld, L.kp, B + L.qb_h, B + L.qb_l, n0, am);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = n0 + 2 * t4 + (r & 1);
      if (d < D) MN[rows[r >> 1] * D + d] = am[0][r];
    }
  }

  // ---- q-variance: sum_j (bf16(A) bf16(tril(Lq_d)))[., j]^2 ----------------
  for (int d = 0; d < D; ++d) {
    float qv[2] = {0.0f, 0.0f};
    for (int n0 = 0; n0 < L.mn; n0 += 8 * kNT) {
      warp_product<false, kNT>(As, ld, L.kp,
                               B + L.lqb + (size_t)d * L.mn * L.kp, nullptr,
                               n0, acc);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qv[r >> 1] = fmaf(acc[nt][r], acc[nt][r], qv[r >> 1]);
    }
    qv[0] = quad_sum(qv[0]);
    qv[1] = quad_sum(qv[1]);
    if (t4 == 0) {
      VQ[g * D + d] = qv[0];
      VQ[(g + 8) * D + d] = qv[1];
    }
  }
  __syncwarp();

  // ---- outputs --------------------------------------------------------------
  for (int idx = lane; idx < kRows * D; idx += 32) {
    const int r = idx / D, n = row0 + r;
    if (n >= N) continue;
    const size_t o = (size_t)row0 * D + idx;
    const float v = fmaxf(var - SS[r], 0.0f) + VQ[idx];
    mean_o[o] = MN[idx];
    var_o[o] = v;
    if (samp_o != nullptr) samp_o[o] = MN[idx] + sqrtf(fmaxf(v, 1e-12f)) * eps[o];
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch `serve_cond_launch` takes.
long long serve_cond_scratch_bytes(int d_in, int M, int D) {
  return (long long)Layout(d_in, M, D).total;
}

// xs [N, d_in], zs [M, d_in], var [1], linv [M, M], qmu [M, D], lq [D, M, M]
// (f32, contiguous, on the device); eps [N, D] or null. Writes mean and
// varo [N, D], and samp [N, D] with eps (null without). Returns the CUDA
// error code (0 on success); cudaErrorInvalidValue where one warp's rows
// at this M do not fit a block's shared memory.
int serve_cond_launch(const float* xs, const float* zs, const float* var,
                      const float* linv, const float* qmu, const float* lq,
                      const float* eps, float* mean, float* varo, float* samp,
                      void* scratch, int N, int d_in, int M, int D, int device,
                      void* stream) {
  if (N <= 0 || d_in <= 0 || M <= 0 || D <= 0 || (eps == nullptr) != (samp == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L(d_in, M, D);
  const size_t elems = (size_t)L.mn * L.kx + (size_t)L.mn * L.kp +
                       (size_t)L.dn * L.kp + (size_t)D * L.mn * L.kp + L.mn;
  const int blocks = (int)std::min<size_t>((elems + 255) / 256, 1 << 16);
  prep_kernel<<<blocks, 256, 0, s>>>(zs, linv, qmu, lq, scratch, d_in, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp = sizeof(float) * (size_t)warp_floats(d_in, M, D);
  const int warps = (int)std::min<size_t>(kMaxWarps, kSmemMax / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps;
  err = cudaFuncSetAttribute(serve_cond_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kRows * warps;
  serve_cond_kernel<<<(N + rows - 1) / rows, 32 * warps, smem, s>>>(
      xs, var, scratch, eps, mean, varo, samp, N, d_in, M, D);
  return (int)cudaGetLastError();
}

const char* serve_cond_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
