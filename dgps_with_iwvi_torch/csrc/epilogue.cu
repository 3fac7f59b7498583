// Fused whitened-conditional epilogue: q-variance, prior sum of squares and
// mean in one pass over each tile of A.
//
// Replaces the TPU kernels dgps_with_iwvi_tpu/ops/pallas/qvar.py
// `_epi_kernel` (l.429) and, with the mean and the sum of squares switched
// off, `_qvar_kernel` (l.96). For A [L, M, N], W [D, M, M], q_mu [M, D]:
//
//   qv[l, d, n]   = sum_m (W_d^T A_l)[m, n]^2            (root form)
//                 = sum_m A_l[m, n] * (W_d A_l)[m, n]    (covariance form)
//   ss[l, n]      = sum_m A_l[m, n]^2                    (exact f32)
//   mean[l, d, n] = sum_m q_mu[m, d] A_l[m, n]           (bf16x3, `_dot3`)
//
// Rounding follows the TPU kernel exactly: the quadratic form multiplies W_d
// and A rounded to bf16 into an f32 accumulator (here mma.sync m16n8k16 with
// bf16 operands and f32 accumulation), then squares (root) or multiplies by
// the f32 A (cov) and sums in f32; the mean uses the hi/lo bf16 split of
// both operands, hi*hi + hi*lo + lo*hi with lo*lo dropped, each product exact
// in f32.
//
// What bounds it on the H100: at the serving shape (L=100, M=128, N=8192) the
// D=8 inner layer does 2*L*D*M^2*N = 2.1e11 bf16 tensor-core FLOP against
// 419 MB of A read (0.22 ms of compute vs 0.13 ms of bytes: compute-bound);
// the D=1 final layer is bound by reading A. The design: each block owns one
// (l, 128-column tile) and works through M in chunks of 128 rows, padded
// with zeros past M in the kernel (zero rows of A and of W add nothing to
// any sum), so the kernel serves every M (one instantiation for M <= 128,
// one for more). Each chunk of the A tile is
// read from device memory into shared memory (f32, row stride padded to 132
// floats so fragment reads are bank-conflict free); at M <= 128 that is one
// chunk, read once and kept for all D outputs. The TPU kept the whole W stack
// resident (qvar.py:42); at D=8 that is 512 KB in f32, more than a block's
// 227 KB, so W is streamed one 128x128 block of one W_d at a time (34 KB in
// bf16, pre-rounded and pre-transposed once per call by `prep_w_kernel`).
// Each of the 8 warps owns 16 columns and all 128 rows of a chunk of the
// product, so the reduction over m stays inside the warp (registers and
// shuffles, no shared memory, no atomics, a fixed order); the warp's bf16
// fragments of A are built once per resident chunk and reused for every d.
// The mean and the sum of squares run on the CUDA cores from the same shared
// chunk, with q_mu's hi/lo split staged in shared memory 8 outputs at a time.
// 108 KB of shared memory and at most 128 registers let two blocks share an
// SM at M <= 128. Later work: wgmma and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 128;             // columns of A per block
constexpr int kWN = kTN / kWarps;    // columns per warp: two n8 tiles
constexpr int kLDA = kTN + 4;        // f32 row stride of the shared A chunk
constexpr int kC = 128;              // rows of M per chunk (m and k alike)
constexpr int kLDW = kC + 8;         // bf16 row stride of the shared W block
constexpr int kT = kC / 16;          // m tiles / k steps of 16 per chunk
constexpr int kDS = 8;               // outputs d per pass of the mean
static_assert(kThreads == 2 * kTN, "the mean gives each column two threads");

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

// Wop[d, m, k] = bf16(root ? W[d, k, m] : W[d, m, k]) for m, k < M, zero up
// to padded_m(M): the "A" operand (row-major Mp x Mp) of T = Wop_d @ A.
__global__ void prep_w_kernel(const float* __restrict__ W,
                              __nv_bfloat16* __restrict__ Wop, int D, int M,
                              int cov) {
  const int Mp = padded_m(M);
  const size_t total = (size_t)D * Mp * Mp;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % Mp);
    const size_t dm = idx / Mp;
    const int m = (int)(dm % Mp);
    const int d = (int)(dm / Mp);
    float v = 0.0f;
    if (m < M && k < M)
      v = cov ? W[((size_t)d * M + m) * M + k] : W[((size_t)d * M + k) * M + m];
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

// kOneChunk: M <= 128, a single chunk, known when compiling (the chunk
// loops and their state fold away, and 128 registers suffice for two blocks
// per SM; the chunked kernel takes more registers instead of spilling).
template <bool kOneChunk>
__global__ void __launch_bounds__(kThreads, kOneChunk ? 2 : 1)
epilogue_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ Wop,
                const float* __restrict__ qmu, float* __restrict__ qv,
                float* __restrict__ ss, float* __restrict__ mean, int M, int D,
                int N, int cov) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);                       // [kC][kLDA]
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(As + kC * kLDA);  // [kC][kLDW]
  float* Qh = reinterpret_cast<float*>(Ws + kC * kLDW);  // [kC][kDS] hi of q_mu
  float* Ql = Qh + kC * kDS;                             // [kC][kDS] lo of q_mu

  const int Mp = padded_m(M);
  const int C = kOneChunk ? 1 : Mp / kC;  // chunks of M
  const int l = blockIdx.y;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const float* Al = A + (size_t)l * M * N;
  int resident = -1;  // the chunk of A in As (the same in every thread)

  // ---- prior sum of squares and the bf16x3 mean, on the CUDA cores --------
  // Chunk by chunk; each output is owned by one thread, which adds the
  // chunk's partial sum to what it wrote for the previous chunks.
  if (ss != nullptr || mean != nullptr) {
    for (int kc = 0; kc < C; ++kc) {
      __syncthreads();  // every thread is done with the previous chunk
      load_a_chunk(As, Al, kc, M, N, n0);
      resident = kc;
      __syncthreads();
      const int rows = min(kC, M - kc * kC);
      if (ss != nullptr) {
        for (int j = tid; j < kTN; j += kThreads) {
          const int n = n0 + j;
          if (n >= N) continue;
          float s = 0.0f;
          for (int r = 0; r < rows; ++r) {
            const float a = As[r * kLDA + j];
            s = fmaf(a, a, s);
          }
          float* out = ss + (size_t)l * N + n;
          *out = kc == 0 ? s : *out + s;
        }
      }
      if (mean != nullptr) {
        // thread: column j, outputs d0 + h + 2i; q_mu's hi/lo split of this
        // chunk's rows and kDS outputs staged in shared memory
        const int j = tid % kTN, h = tid / kTN;
        const int n = n0 + j;
        for (int d0 = 0; d0 < D; d0 += kDS) {
          __syncthreads();  // every thread is done with the previous slice
          for (int idx = tid; idx < kC * kDS; idx += kThreads) {
            const int r = idx / kDS, d = d0 + idx % kDS;
            const int m = kc * kC + r;
            const float q = (m < M && d < D) ? qmu[(size_t)m * D + d] : 0.0f;
            const float qh = round_bf16(q);
            Qh[idx] = qh;
            Ql[idx] = round_bf16(q - qh);
          }
          __syncthreads();
          // this thread's outputs below D (the same in the whole warp)
          const int nd = min(kDS / 2, (D - d0 - h + 1) / 2);
          if (nd <= 0) continue;  // e.g. the second half of the block at D=1
          float hh[kDS / 2], hl[kDS / 2], lh[kDS / 2];
#pragma unroll
          for (int i = 0; i < kDS / 2; ++i) hh[i] = hl[i] = lh[i] = 0.0f;
          for (int r = 0; r < rows; ++r) {
            const float a = As[r * kLDA + j];
            const float ah = round_bf16(a), al = round_bf16(a - ah);
#pragma unroll
            for (int i = 0; i < kDS / 2; ++i) {  // zeros of q past D: no-ops
              const float qh = Qh[r * kDS + h + 2 * i];
              const float ql = Ql[r * kDS + h + 2 * i];
              hh[i] = fmaf(qh, ah, hh[i]);
              hl[i] = fmaf(qh, al, hl[i]);
              lh[i] = fmaf(ql, ah, lh[i]);
            }
          }
          if (n < N) {
#pragma unroll
            for (int i = 0; i < kDS / 2; ++i) {
              if (i >= nd) break;
              const int d = d0 + h + 2 * i;
              const float s = (hh[i] + hl[i]) + lh[i];
              float* out = mean + ((size_t)l * D + d) * N + n;
              *out = kc == 0 ? s : *out + s;
            }
          }
        }
      }
    }
  }

  // ---- the quadratic form on the tensor cores -----------------------------
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = warp * kWN;  // first column of this warp
  constexpr int kRowVec = kC * 2 / 16;  // uint4 per row of a W block
  // B operand (K x N, "col") of the resident chunk: b0 = A[k..k+1][col],
  // b1 = rows +8; built again only when another chunk becomes resident
  uint32_t bfrag[kT][2][2];
  int built = -1;

  for (int d = 0; d < D; ++d) {
    float tot[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [nt][column 2t4 + i]
    for (int mc = 0; mc < C; ++mc) {
      float acc[kT][2][4];
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;

      // k chunks in an order that ends at mc, so that As then holds the A
      // rows the covariance form multiplies by
      for (int i = 0; i < C; ++i) {
        const int kc = (mc + 1 + i) % C;
        __syncthreads();  // every warp is done with the previous As / Ws
        if (kc != resident) {
          load_a_chunk(As, Al, kc, M, N, n0);
          resident = kc;
        }
        const uint4* src = reinterpret_cast<const uint4*>(
            Wop + ((size_t)d * Mp + (size_t)mc * kC) * Mp + (size_t)kc * kC);
        uint4* dst = reinterpret_cast<uint4*>(Ws);
        for (int v = tid; v < kC * kRowVec; v += kThreads) {
          const int r = v / kRowVec, c = v % kRowVec;
          dst[r * (kLDW * 2 / 16) + c] = src[(size_t)r * (Mp * 2 / 16) + c];
        }
        __syncthreads();
        if (built != kc) {
#pragma unroll
          for (int kt = 0; kt < kT; ++kt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int col = wc + nt * 8 + g;
              const int k = kt * 16 + t4 * 2;
              bfrag[kt][nt][0] =
                  pack_bf16(As[k * kLDA + col], As[(k + 1) * kLDA + col]);
              bfrag[kt][nt][1] =
                  pack_bf16(As[(k + 8) * kLDA + col], As[(k + 9) * kLDA + col]);
            }
          built = kc;
        }

#pragma unroll
        for (int kt = 0; kt < kT; ++kt) {
#pragma unroll
          for (int mt = 0; mt < kT; ++mt) {
            // A operand (row-major 16 x 16): rows g / g+8, cols 2t4.. / +8..
            const __nv_bfloat16* w0 = Ws + (mt * 16 + g) * kLDW + kt * 16 + t4 * 2;
            const __nv_bfloat16* w8 = w0 + 8 * kLDW;
            const uint32_t a0 = *reinterpret_cast<const uint32_t*>(w0);
            const uint32_t a1 = *reinterpret_cast<const uint32_t*>(w8);
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(w0 + 8);
            const uint32_t a3 = *reinterpret_cast<const uint32_t*>(w8 + 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_bf16(acc[mt][nt], a0, a1, a2, a3, bfrag[kt][nt][0],
                       bfrag[kt][nt][1]);
          }
        }
      }

      // accumulator (mt, nt): c0/c1 at row mt*16+g, cols 2t4, 2t4+1; c2/c3
      // at row +8. Sum over this thread's rows of the chunk.
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c0 = wc + nt * 8 + t4 * 2;
#pragma unroll
        for (int mt = 0; mt < kT; ++mt) {
          const float* c = acc[mt][nt];
          if (cov) {
            const int r0 = mt * 16 + g, r1 = r0 + 8;
            tot[nt][0] += As[r0 * kLDA + c0] * c[0] + As[r1 * kLDA + c0] * c[2];
            tot[nt][1] +=
                As[r0 * kLDA + c0 + 1] * c[1] + As[r1 * kLDA + c0 + 1] * c[3];
          } else {
            tot[nt][0] += c[0] * c[0] + c[2] * c[2];
            tot[nt][1] += c[1] * c[1] + c[3] * c[3];
          }
        }
      }
    }

    // then over the 8 lanes sharing t4
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float s0 = tot[nt][0], s1 = tot[nt][1];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0) {
        const int n = n0 + wc + nt * 8 + t4 * 2;
        float* out = qv + ((size_t)l * D + d) * N;
        if (n < N) out[n] = s0;
        if (n + 1 < N) out[n + 1] = s1;
      }
    }
  }
}

constexpr size_t kSmem = (size_t)kC * kLDA * sizeof(float) +
                         (size_t)kC * kLDW * sizeof(__nv_bfloat16) +
                         2 * (size_t)kC * kDS * sizeof(float);

}  // namespace

extern "C" {

// bf16 elements of the W scratch `epilogue_launch` takes.
long long epilogue_wop_elems(int M, int D) {
  return (long long)D * padded_m(M) * padded_m(M);
}

// A [L, M, N], W [D, M, M], q_mu [M, D] (or null) -> qv [L, D, N],
// ss [L, N] (or null), mean [L, D, N] (null iff q_mu is null). wop is
// scratch of epilogue_wop_elems(M, D) bf16. All contiguous; any M, D, N.
// Returns the CUDA error code of the launches (0 on success).
int epilogue_launch(const float* A, const float* W, const float* qmu,
                    float* qv, float* ss, float* mean, void* wop, int L,
                    int M, int N, int D, int cov, int device, void* stream) {
  if (L <= 0 || M <= 0 || N <= 0 || D <= 0 ||
      ((qmu == nullptr) != (mean == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* Wop = reinterpret_cast<__nv_bfloat16*>(wop);
  const long long total = epilogue_wop_elems(M, D);
  const int blocks = (int)std::min<long long>((total + kThreads - 1) / kThreads,
                                              1 << 16);
  prep_w_kernel<<<blocks, kThreads, 0, s>>>(W, Wop, D, M, cov);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool one = M <= kC;
  err = one ? cudaFuncSetAttribute(epilogue_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmem)
            : cudaFuncSetAttribute(epilogue_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  // grid.y is at most 65535: slices of L
  for (int l0 = 0; l0 < L; l0 += 65535) {
    const int rows = std::min(L - l0, 65535);
    dim3 grid((N + kTN - 1) / kTN, rows);
    const size_t off = (size_t)l0 * D * N;
    const float* Ab = A + (size_t)l0 * M * N;
    float* ssb = ss != nullptr ? ss + (size_t)l0 * N : nullptr;
    float* meanb = mean != nullptr ? mean + off : nullptr;
    if (one)
      epilogue_kernel<true><<<grid, kThreads, kSmem, s>>>(
          Ab, Wop, qmu, qv + off, ssb, meanb, M, D, N, cov);
    else
      epilogue_kernel<false><<<grid, kThreads, kSmem, s>>>(
          Ab, Wop, qmu, qv + off, ssb, meanb, M, D, N, cov);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
