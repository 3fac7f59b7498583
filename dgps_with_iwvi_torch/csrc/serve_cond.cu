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
// dropped. Every product is mma.sync m16n8k16 with bf16 fragments and f32
// accumulators; the three passes of a dot3 add into one accumulator.
//
// What bounds it on the H100: at the serving inner layer (N = 819,200, M =
// 128, d_in = 9, D = 8) the products are 2 N M (3 d_in + 3 M + 3 D) bf16
// FLOP for the dot3s plus N M (M + 1) D for the q-variance against
// tril(Lq): 2.0e11 FLOP, 0.20 ms at 989 TF/s, against 86 MB of inputs and
// outputs (0.03 ms): operation-bound. Multiplying the dense zero-padded Lq_d
// would do 2 M^2 instead of M (M + 1) per row and d, 1.56x the bound's work
// at this shape. A kernel of one warp per 16 rows that reads every
// right-hand fragment from L1/L2 for its own rows moves ~17 GB of operand
// traffic per call there, and re-cuts A from f32 into hi/lo per product.
//
// The design (M <= 128, every main path): a persistent block of 8 warps
// holds the right-hand operands in shared memory, split and laid out once
// per call by `prep_kernel`: zs, Linv^T and q_mu, hi and lo ([n][k] bf16,
// 89 KB with row padding at M = 128), loaded once per block; the block
// walks over row tiles of 128 until N is done, so each operand byte from
// L2 serves every row the block works on. tril(Lq_d) streams through a
// two-stage cp.async ring, one d at a time, copying only the 16 x 16 tiles
// on or below the diagonal (36 of 64 at M = 128); with D <= 2 it stays
// resident. Each warp owns 16 rows of a 128-row tile and keeps the chain in
// registers, as FlashAttention keeps its scores: the gram accumulator gets
// exp applied in registers, is split once into bf16 hi/lo A-fragments
// (the m16n8k16 accumulator of two n8 tiles is the A-fragment of one k16
// step), which feed the Linv product; A's accumulator is split once into
// hi/lo fragments that serve the mean and all D q-variance products. B
// fragments are read with ldmatrix (row stride 272 bytes: free of bank
// conflicts). The q-variance of column tile n8 = t runs only over the k16
// steps kk >= t / 2, a loop with fixed trip counts and no divergence. One
// barrier per d (the ring); none in the rest of the chain. Row sums reduce
// over the 4 lanes of a quad with shuffles, in a fixed order. At M > 128
// the chain no longer fits in registers: a warp then keeps its rows' x,
// Kxz and A in shared memory in f32 and reads the right-hand fragments from
// device memory (`wide_kernel`, with the same tril skip).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 16;           // rows per warp
constexpr int kMaxWarps = 4;        // wide_kernel
constexpr int kNT = 16;             // n8 tiles per output chunk (128 columns)
constexpr int kSmemMax = 232448;    // bytes a block may use on the H100
constexpr int kWarps = 8;           // chain_kernel: 8 warps, 128 rows a tile
constexpr int kMC = 128;            // chain_kernel: M padded to 128
constexpr int kLdB = kMC + 8;       // bf16 row stride of [n][k] tiles (272 B)

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

__device__ __forceinline__ void split(float v, bf16* h, bf16* l) {
  const bf16 hi = __float2bfloat16_rn(v);
  *h = hi;
  if (l != nullptr) *l = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__global__ void prep_kernel(const float* __restrict__ zs,
                            const float* __restrict__ linv,
                            const float* __restrict__ qmu,
                            const float* __restrict__ lq, void* scratch,
                            int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  bf16* B = reinterpret_cast<bf16*>(scratch);
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

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// B operands of the n8 tiles at columns n0 and n0 + 8, depth k0..k0+15, of
// Y stored [n][k] (row stride ld): b[0], b[1] the first tile, b[2], b[3] the
// second.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* Y, int ld,
                                       int n0, int k0, int lane) {
  ldsm_x4(b, Y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum over the 4 lanes of a quad (the lanes that share rows g and g+8).
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// (hi, lo) bf16x2 words of the pair (a, b): hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& h,
                                       uint32_t& l) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
  h = as_u32(hv);
  l = as_u32(__floats2bfloat162_rn(a - __low2float(hv), b - __high2float(hv)));
}

// ---- chain_kernel: M <= 128 -------------------------------------------------

struct ChainSmem {
  bf16 *zh, *zl;    // [128][kx + 8]   zs
  bf16 *lh, *ll;    // [128][kLdB]     Linv
  bf16 *qh, *ql;    // [dq][kLdB]      q_mu^T, dq = round_up(D, 16)
  bf16* lq;         // [2][128][kLdB]  tril(Lq_d), the ring
  float* zz;        // [128]
  float* mv;        // [kWarps][16 (2 D + 1)] per warp: mean, q-variance, sum A^2
};

__host__ __device__ inline size_t chain_smem_bytes(int kx, int D, ChainSmem* s,
                                                   unsigned char* raw) {
  const int dq = round_up(D, 16);
  const size_t nz = (size_t)kMC * (kx + 8), nl = (size_t)kMC * kLdB,
               nq = (size_t)dq * kLdB;
  const size_t bf = 2 * nz + 2 * nl + 2 * nq + 2 * nl;
  const size_t bytes =
      bf * sizeof(bf16) + sizeof(float) * (kMC + (size_t)kWarps * 16 * (2 * D + 1));
  if (s != nullptr) {
    bf16* p = reinterpret_cast<bf16*>(raw);
    s->zh = p;
    s->zl = s->zh + nz;
    s->lh = s->zl + nz;
    s->ll = s->lh + nl;
    s->qh = s->ll + nl;
    s->ql = s->qh + nq;
    s->lq = s->ql + nq;
    s->zz = reinterpret_cast<float*>(s->lq + 2 * nl);
    s->mv = s->zz + kMC;
  }
  return bytes;
}

// cp.async of `rows` rows of `cols` bf16 (a multiple of 8) from a [rows][gld]
// array into a [rows][sld] one, by the whole block.
__device__ __forceinline__ void copy_rows(bf16* dst, int sld, const bf16* src,
                                          int gld, int rows, int cols) {
  const int chunks = cols / 8;
  for (int v = threadIdx.x; v < rows * chunks; v += blockDim.x) {
    const int r = v / chunks, c = v % chunks;
    cp_async16(dst + r * sld + c * 8, src + (size_t)r * gld + c * 8);
  }
}

// cp.async of tril(Lq_d)'s 16 x 16 tiles on or below the diagonal: row n
// (a column of tril(Lq_d)) from k = 16 (n / 16) on.
__device__ __forceinline__ void issue_lq(bf16* dst, const bf16* src) {
  for (int v = threadIdx.x; v < kMC * (kMC / 8); v += blockDim.x) {
    const int n = v / (kMC / 8), q = v % (kMC / 8);
    if (q >= 2 * (n >> 4))
      cp_async16(dst + n * kLdB + q * 8, src + (size_t)n * kMC + q * 8);
  }
}

__global__ void __launch_bounds__(32 * kWarps, 1)
chain_kernel(const float* __restrict__ xs, const float* __restrict__ var_p,
             const void* __restrict__ scratch, const float* __restrict__ eps,
             float* __restrict__ mean_o, float* __restrict__ var_o,
             float* __restrict__ samp_o, int N, int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  const bf16* B = reinterpret_cast<const bf16*>(scratch);
  const float* zz_g = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(scratch) + L.zz_bytes);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem sm;
  chain_smem_bytes(L.kx, D, &sm, smem_raw);
  const int ldz = L.kx + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int dq = round_up(D, 16);
  const int tiles = (N + kWarps * kRows - 1) / (kWarps * kRows);
  const bool resident = D <= 2;  // every Lq_d fits the ring: load it once

  // the right-hand operands, once per block; q_mu's rows past dn are zeros
  copy_rows(sm.zh, ldz, B + L.zb_h, L.kx, kMC, L.kx);
  copy_rows(sm.zl, ldz, B + L.zb_l, L.kx, kMC, L.kx);
  copy_rows(sm.lh, kLdB, B + L.lb_h, kMC, kMC, kMC);
  copy_rows(sm.ll, kLdB, B + L.lb_l, kMC, kMC, kMC);
  copy_rows(sm.qh, kLdB, B + L.qb_h, kMC, L.dn, kMC);
  copy_rows(sm.ql, kLdB, B + L.qb_l, kMC, L.dn, kMC);
  for (int v = threadIdx.x; v < (dq - L.dn) * kLdB; v += blockDim.x) {
    sm.qh[L.dn * kLdB + v] = __float2bfloat16_rn(0.0f);
    sm.ql[L.dn * kLdB + v] = __float2bfloat16_rn(0.0f);
  }
  for (int v = threadIdx.x; v < kMC; v += blockDim.x) sm.zz[v] = zz_g[v];
  for (int d = 0; d < (resident ? D : 1); ++d)
    issue_lq(sm.lq + (size_t)d * kMC * kLdB, B + L.lqb + (size_t)d * kMC * kMC);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float var = *var_p;
  float* MN = sm.mv + (size_t)warp * 16 * (2 * D + 1);  // [16][D]
  float* VQ = MN + 16 * D;                              // [16][D]
  float* SS = VQ + 16 * D;                              // [16]
  int step = 0;                                   // Lq loads consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kWarps * kRows + warp * kRows;
    const int rg = row0 + g, rg8 = rg + 8;

    // ---- Kxz = var exp(-max(xx - 2 dot3(x, z) + zz, 0) / 2) ---------------
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
    float xx[2] = {0.0f, 0.0f};
    for (int k0 = 0; k0 < L.kx; k0 += 16) {
      float x[8];  // (g, c), (g+8, c), (g, c+8), (g+8, c+8) for c = 2t4, +1
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 2 * t4 + 8 * h + e;
          const bool ok = c < d_in;
          x[4 * h + e] = ok && rg < N ? __ldg(xs + (size_t)rg * d_in + c) : 0.0f;
          x[4 * h + 2 + e] =
              ok && rg8 < N ? __ldg(xs + (size_t)rg8 * d_in + c) : 0.0f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xx[0] = fmaf(x[4 * h], x[4 * h], fmaf(x[4 * h + 1], x[4 * h + 1], xx[0]));
        xx[1] = fmaf(x[4 * h + 2], x[4 * h + 2],
                     fmaf(x[4 * h + 3], x[4 * h + 3], xx[1]));
      }
      uint32_t xh[4], xl[4];
      split2(x[0], x[1], xh[0], xl[0]);
      split2(x[2], x[3], xh[1], xl[1]);
      split2(x[4], x[5], xh[2], xl[2]);
      split2(x[6], x[7], xh[3], xl[3]);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bh[4], bl[4];
        load_b(bh, sm.zh, ldz, np * 16, k0, lane);
        load_b(bl, sm.zl, ldz, np * 16, k0, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float(&c)[4] = acc[2 * np + h];
          mma_bf16(c, xh, bh[2 * h], bh[2 * h + 1]);
          mma_bf16(c, xh, bl[2 * h], bl[2 * h + 1]);
          mma_bf16(c, xl, bh[2 * h], bh[2 * h + 1]);
        }
      }
    }
    xx[0] = quad_sum(xx[0]);
    xx[1] = quad_sum(xx[1]);

    // exp in registers, then the split: the accumulators of n8 tiles 2kk and
    // 2kk+1 are the A-fragment of k16 step kk
    uint32_t fh[kNT / 2][4], fl[kNT / 2][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = nt * 8 + 2 * t4 + (r & 1);
        const float d2 = fmaxf(xx[r >> 1] - 2.0f * acc[nt][r] + sm.zz[j], 0.0f);
        kv[r] = j < M ? var * expf(-0.5f * d2) : 0.0f;
      }
      split2(kv[0], kv[1], fh[nt >> 1][(nt & 1) * 2], fl[nt >> 1][(nt & 1) * 2]);
      split2(kv[2], kv[3], fh[nt >> 1][(nt & 1) * 2 + 1],
             fl[nt >> 1][(nt & 1) * 2 + 1]);
    }

    // ---- A = dot3(Kxz, Linv^T); sum_m A^2 ----------------------------------
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kMC / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bh[4], bl[4];
        load_b(bh, sm.lh, kLdB, np * 16, kk * 16, lane);
        load_b(bl, sm.ll, kLdB, np * 16, kk * 16, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float(&c)[4] = acc[2 * np + h];
          mma_bf16(c, fh[kk], bh[2 * h], bh[2 * h + 1]);
          mma_bf16(c, fh[kk], bl[2 * h], bl[2 * h + 1]);
          mma_bf16(c, fl[kk], bh[2 * h], bh[2 * h + 1]);
        }
      }
    float ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {  // zero past M: Linv is zero-padded
      ss[0] = fmaf(acc[nt][0], acc[nt][0], fmaf(acc[nt][1], acc[nt][1], ss[0]));
      ss[1] = fmaf(acc[nt][2], acc[nt][2], fmaf(acc[nt][3], acc[nt][3], ss[1]));
      split2(acc[nt][0], acc[nt][1], fh[nt >> 1][(nt & 1) * 2],
             fl[nt >> 1][(nt & 1) * 2]);
      split2(acc[nt][2], acc[nt][3], fh[nt >> 1][(nt & 1) * 2 + 1],
             fl[nt >> 1][(nt & 1) * 2 + 1]);
    }
    ss[0] = quad_sum(ss[0]);
    ss[1] = quad_sum(ss[1]);
    if (t4 == 0) {
      SS[g] = ss[0];
      SS[g + 8] = ss[1];
    }

    // ---- mean = dot3(A, q_mu), 16 columns of D at a time --------------------
    for (int n0 = 0; n0 < dq; n0 += 16) {
      float cm[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < kMC / 16; ++kk) {
        uint32_t bh[4], bl[4];
        load_b(bh, sm.qh, kLdB, n0, kk * 16, lane);
        load_b(bl, sm.ql, kLdB, n0, kk * 16, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(cm[h], fh[kk], bh[2 * h], bh[2 * h + 1]);
          mma_bf16(cm[h], fh[kk], bl[2 * h], bl[2 * h + 1]);
          mma_bf16(cm[h], fl[kk], bh[2 * h], bh[2 * h + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = n0 + 8 * h + 2 * t4 + (r & 1);
          if (d < D) MN[(g + 8 * (r >> 1)) * D + d] = cm[h][r];
        }
    }

    // ---- q-variance: sum_j (bf16(A) bf16(tril(Lq_d)))[., j]^2 --------------
    for (int d = 0; d < D; ++d) {
      const bf16* lqs;
      if (resident) {
        lqs = sm.lq + (size_t)d * kMC * kLdB;
      } else {
        cp_async_wait_all();
        __syncthreads();  // Lq_d landed; every warp is done with the other stage
        const bool more = d + 1 < D || tile + (int)gridDim.x < tiles;
        if (more)
          issue_lq(sm.lq + (size_t)((step + 1) & 1) * kMC * kLdB,
                   B + L.lqb + (size_t)((d + 1) % D) * kMC * kMC);
        cp_async_commit();
        lqs = sm.lq + (size_t)(step & 1) * kMC * kLdB;
        ++step;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
      // column tiles 2np, 2np+1 are zero for k < 16 np: steps kk >= np only
#pragma unroll
      for (int kk = 0; kk < kMC / 16; ++kk)
#pragma unroll
        for (int np = 0; np <= kk; ++np) {
          uint32_t b[4];
          load_b(b, lqs, kLdB, np * 16, kk * 16, lane);
          mma_bf16(acc[2 * np], fh[kk], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], fh[kk], b[2], b[3]);
        }
      float qv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        qv[0] = fmaf(acc[nt][0], acc[nt][0], fmaf(acc[nt][1], acc[nt][1], qv[0]));
        qv[1] = fmaf(acc[nt][2], acc[nt][2], fmaf(acc[nt][3], acc[nt][3], qv[1]));
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
    __syncwarp();
  }
}

// ---- wide_kernel: M > 128 -------------------------------------------------

// acc[nt] (n8 tile nt of columns n0 + 8 nt ..) = In[16 rows][k_begin, K) @
// B[k_begin, K)[n0 ..] for nt < NT. In: the warp's f32 rows in shared
// memory (stride ldi, zero past the real K); Bh / Bl: [n][K] bf16 in device
// memory.
// kThree: dot3 (hi*hi + hi*lo + lo*hi); else one pass on the hi halves.
// NT is fixed when compiling, so the B loads of a k step are independent of
// any bound and can be issued ahead of their products.
template <bool kThree, int NT>
__device__ __forceinline__ void warp_product(const float* In, int ldi, int K,
                                             const bf16* __restrict__ Bh,
                                             const bf16* __restrict__ Bl,
                                             int n0, int k_begin,
                                             float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  for (int k0 = k_begin; k0 < K; k0 += 16) {
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

__host__ __device__ inline int warp_floats(int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  return kRows * (stride_of(L.kx) + 2 * stride_of(L.kp) + 2 * D + 2);
}

__global__ void __launch_bounds__(32 * kMaxWarps)
wide_kernel(const float* __restrict__ xs, const float* __restrict__ var_p,
                  const void* __restrict__ scratch, const float* __restrict__ eps,
                  float* __restrict__ mean_o, float* __restrict__ var_o,
                  float* __restrict__ samp_o, int N, int d_in, int M, int D) {
  const Layout L(d_in, M, D);
  const bf16* B = reinterpret_cast<const bf16*>(scratch);
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
    warp_product<true, kNT>(Xs, ldx, L.kx, B + L.zb_h, B + L.zb_l, n0, 0, acc);
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
    warp_product<true, kNT>(Ks, ld, L.kp, B + L.lb_h, B + L.lb_l, n0, 0, acc);
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
    warp_product<true, 1>(As, ld, L.kp, B + L.qb_h, B + L.qb_l, n0, 0, am);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = n0 + 2 * t4 + (r & 1);
      if (d < D) MN[rows[r >> 1] * D + d] = am[0][r];
    }
  }

  // ---- q-variance: sum_j (bf16(A) bf16(tril(Lq_d)))[., j]^2; the columns
  // from n0 on are zero for k < n0, so their k loop starts there ---------------
  for (int d = 0; d < D; ++d) {
    float qv[2] = {0.0f, 0.0f};
    for (int n0 = 0; n0 < L.mn; n0 += 8 * kNT) {
      warp_product<false, kNT>(As, ld, L.kp,
                               B + L.lqb + (size_t)d * L.mn * L.kp, nullptr,
                               n0, n0, acc);
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
// error code (0 on success); cudaErrorInvalidValue where the operands at
// this M and D do not fit a block's shared memory.
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

  const size_t chain = chain_smem_bytes(L.kx, D, nullptr, nullptr);
  if (L.kp == kMC && chain <= (size_t)kSmemMax) {
    // the attribute and the block slots of the card, set and queried once
    // per (device, shared memory size)
    static int cached_device = -1;
    static size_t cached_smem = 0;
    static int slots = 1;
    if (device != cached_device || chain != cached_smem) {
      err = cudaFuncSetAttribute(chain_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)chain);
      if (err != cudaSuccess) return (int)err;
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return (int)err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chain_kernel, 32 * kWarps, chain);
      if (err != cudaSuccess) return (int)err;
      slots = std::max(1, sms * per_sm);
      cached_device = device;
      cached_smem = chain;
    }
    const int tiles = (N + kWarps * kRows - 1) / (kWarps * kRows);
    const int grid = std::min(tiles, slots);
    chain_kernel<<<grid, 32 * kWarps, chain, s>>>(xs, var, scratch, eps, mean,
                                                   varo, samp, N, d_in, M, D);
    return (int)cudaGetLastError();
  }

  const size_t per_warp = sizeof(float) * (size_t)warp_floats(d_in, M, D);
  const int warps = (int)std::min<size_t>(kMaxWarps, kSmemMax / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per_warp * warps;
  err = cudaFuncSetAttribute(wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kRows * warps;
  wide_kernel<<<(N + rows - 1) / rows, 32 * warps, smem, s>>>(
      xs, var, scratch, eps, mean, varo, samp, N, d_in, M, D);
  return (int)cudaGetLastError();
}

const char* serve_cond_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
