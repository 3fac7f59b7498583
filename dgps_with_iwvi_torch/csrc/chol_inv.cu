// Batched Cholesky factor and triangular inverse, blocked, one thread block
// per (matrix, jitter level).
//
// Replaces the TPU kernel dgps_with_iwvi_tpu/ops/pallas/chol.py
// `_chol_inv_kernel` (l.101): (L, L^-1) of a batch of SPD matrices in exact
// f32, with a non-positive pivot leaving a non-finite or non-positive diagonal
// so that the jitter ladder's usability test (`_chol_ok`) rejects the factor.
//
// The launch also covers the whole jitter ladder of chol_and_inverse
// (dgps_with_iwvi_tpu/ops/linalg.py:140-180): block (g, t) factors
// K[g] + jitter[t] * I, so all T levels of all G matrices run in one launch
// and the caller picks, per matrix, the first usable level with no host sync.
//
// What bounds it on the H100: not bytes (G*T*3*M*M*4 = 1.2 MB at G=2, T=4,
// M=128) nor FLOPs (~(2/3) M^3 per matrix), but the chain of dependent
// steps inside one block: latency. Only G*T blocks run (8 for the served
// Kuu, 2 for natgrad's P), so the launch costs one block's chain. The
// design shortens that chain and keeps every step but the pivots parallel:
//
// - The working set lives in shared memory, padded to Mp = M rounded up to
//   the panel width NB with an identity block (blockdiag(K, I) factors to
//   blockdiag(L, I) exactly), so every tile has a compile-time shape. Two
//   [Mp][Mp+1] f32 arrays (the +1 makes column walks bank-conflict free).
// - Factorization, right-looking by panels of NB columns, three barriers per
//   panel: (a) one warp factors the NB x NB diagonal block in registers, lane
//   i holding row i, pivots and columns passed by shuffles, no barrier per
//   column; (b) each row below solves against the diagonal block by
//   substitution (one thread per row, the row in registers); (c) the trailing
//   lower triangle takes the rank-NB update, tile by tile (lower-triangle
//   tiles only), each thread a register tile of (NB/8) x (NB/8) FFMA sums.
// - Inverse, block row by block row (two barriers each): the right-hand
//   sides -sum_j L[i][j] X[j][k] of every block column k < i at once, as
//   register-tiled products; then every column of the block row solves
//   against the diagonal block by substitution, one thread per column. The
//   substitutions keep the column-wise backward error of forward
//   substitution (|L x - e| <= c u |L| |x|) that the unblocked kernel had.
//
// Past Mp = 160 the two arrays no longer fit in a block's 227 KB; the
// unblocked kernel then works in place in its L and L^-1 outputs in device
// memory (row stride M). That path serves no model of the repo's main paths.
//
// All arithmetic is plain f32 (no TF32, no bf16). Outputs carry exact zeros
// above the diagonal by a select, never a multiply (NaN * 0 = NaN).

#include <cuda_runtime.h>
#include <math.h>

// The device functions live in a namespace named for the kernel, so
// that a profiler's rows name it (SYMBOLS in ops/hopper/cost.py).
namespace k1_chol_inv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Panel width. The code also takes 16 (a warp holds at most 32 rows of the
// diagonal block, and a tile is 8 x 8 register tiles); 16 ran slower than
// 32 on the H100 at the served Kuu and natgrad shapes.
constexpr int kNB = 32;
constexpr int kR = kNB / 8;  // register tile side of the tile products
static_assert(kNB == 16 || kNB == 32, "panel width 16 or 32");

__host__ __device__ constexpr int padded(int m) {
  return (m + kNB - 1) / kNB * kNB;
}

// Two [Mp][Mp+1] f32 arrays and the pivots' reciprocals.
__host__ __device__ constexpr size_t smem_bytes(int mp) {
  return (2 * (size_t)mp * (mp + 1) + mp) * sizeof(float);
}

constexpr int kMaxShared = 232448;  // a block's dynamic shared memory
constexpr bool in_shared(int m) {
  return smem_bytes(padded(m)) <= (size_t)kMaxShared;
}

// ---- blocked kernel, working set in shared memory ------------------------

// (a) One warp factors the diagonal block at (kb, kb); lane i < NB holds row
// i. Writes L's block (lower part) and 1 / L_jj into rd[kb + j].
__device__ __forceinline__ void factor_diag(float* a, float* rd, int ld,
                                            int kb, int lane) {
  const int row = lane < kNB ? lane : kNB - 1;
  float r[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) r[c] = a[(kb + row) * ld + kb + c];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float piv = __shfl_sync(0xffffffffu, r[j], j);
    const float d = sqrtf(piv);  // NaN for a negative pivot, 0 for a zero one
    const float inv = 1.0f / d;
    if (lane == j) {
      r[j] = d;
      rd[kb + j] = inv;
    } else if (lane > j) {
      r[j] *= inv;
    }
    // rows below take the rank-1 update; lanes above j update entries above
    // the diagonal, which are never read
#pragma unroll
    for (int c = j + 1; c < kNB; ++c) {
      const float lcj = __shfl_sync(0xffffffffu, r[j], c);
      r[c] = fmaf(-r[j], lcj, r[c]);
    }
  }
  if (lane < kNB) {
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (c <= lane) a[(kb + lane) * ld + kb + c] = r[c];
  }
}

// x[0..NB) := x L_d^-T for the diagonal block L_d at (kb, kb): row
// substitution, x_j = (x_j - sum_{c<j} x_c L[j][c]) / L[j][j].
__device__ __forceinline__ void solve_row(float (&x)[kNB], const float* a,
                                          const float* rd, int ld, int kb) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    x[j] *= rd[kb + j];
#pragma unroll
    for (int c = j + 1; c < kNB; ++c)
      x[c] = fmaf(-x[j], a[(kb + c) * ld + kb + j], x[c]);
  }
}

// x[0..NB) := L_d^-1 x for the diagonal block at (kb, kb): column
// substitution.
__device__ __forceinline__ void solve_col(float (&x)[kNB], const float* a,
                                          const float* rd, int ld, int kb) {
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    x[i] *= rd[kb + i];
#pragma unroll
    for (int r = i + 1; r < kNB; ++r)
      x[r] = fmaf(-a[(kb + r) * ld + kb + i], x[i], x[r]);
  }
}

// The (ty, tx) register tile of sum_kk P[r][kk] Q[c][kk] over kk in
// [k0, k0 + NB), rows r = rb + ty + 8 q, columns c = cb + tx + 8 p.
__device__ __forceinline__ void tile_nt(float (&acc)[kR][kR], const float* P,
                                        const float* Q, int ld, int rb,
                                        int cb, int k0, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kNB; ++kk) {
    float p[kR], q[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      p[i] = P[(rb + ty + 8 * i) * ld + k0 + kk];
      q[i] = Q[(cb + tx + 8 * i) * ld + k0 + kk];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(p[i], q[j], acc[i][j]);
  }
}

// The same with Q read down columns: sum_kk P[r][kk] Q[kk][c].
__device__ __forceinline__ void tile_nn(float (&acc)[kR][kR], const float* P,
                                        const float* Q, int ld, int rb,
                                        int cb, int k0, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kNB; ++kk) {
    float p[kR], q[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      p[i] = P[(rb + ty + 8 * i) * ld + k0 + kk];
      q[i] = Q[(k0 + kk) * ld + cb + tx + 8 * i];
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(p[i], q[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
chol_inv_blocked(const float* __restrict__ K,
                 const float* __restrict__ jitters, float* __restrict__ L,
                 float* __restrict__ Linv, int G, int M) {
  extern __shared__ float smem[];
  const int Mp = padded(M);
  const int nb = Mp / kNB;
  const int ld = Mp + 1;
  float* a = smem;            // K + jitter I, then L (lower part)
  float* x = a + Mp * ld;     // L^-1 (lower part)
  float* rd = x + Mp * ld;    // 1 / L_jj
  const int g = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float jit = jitters[t];
  const float* Kg = K + (size_t)g * M * M;

  // blockdiag(K + jitter I, I): rows by warp, columns by lane
  for (int i = warp; i < Mp; i += kWarps)
    for (int j = lane; j < Mp; j += 32) {
      float v;
      if (i < M && j < M)
        v = Kg[(size_t)i * M + j] + (i == j ? jit : 0.0f);
      else
        v = i == j ? 1.0f : 0.0f;
      a[i * ld + j] = v;
    }
  __syncthreads();

  // ---- factorization, panel by panel ---------------------------------------
  for (int k = 0; k < nb; ++k) {
    const int kb = k * kNB;
    if (warp == 0) factor_diag(a, rd, ld, kb, lane);
    __syncthreads();
    // (b) the panel below: row i := row i L_kk^-T
    for (int i = kb + kNB + tid; i < Mp; i += kThreads) {
      float r[kNB];
#pragma unroll
      for (int c = 0; c < kNB; ++c) r[c] = a[i * ld + kb + c];
      solve_row(r, a, rd, ld, kb);
#pragma unroll
      for (int c = 0; c < kNB; ++c) a[i * ld + kb + c] = r[c];
    }
    __syncthreads();
    // (c) trailing lower-triangle tiles (bi >= bj > k): A -= L_ik L_jk^T;
    // tile row bi holds bi - k tiles, 64 threads per tile
    const int tiles = (nb - k - 1) * (nb - k) / 2;
    for (int item = tid; item < tiles * 64; item += kThreads) {
      int rem = item >> 6, bi = k + 1;
      while (rem >= bi - k) {
        rem -= bi - k;
        ++bi;
      }
      const int bj = k + 1 + rem;
      const int ty = (item & 63) >> 3, tx = item & 7;
      float acc[kR][kR] = {};
      tile_nt(acc, a, a, ld, bi * kNB, bj * kNB, kb, ty, tx);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          float* e = a + (bi * kNB + ty + 8 * i) * ld + bj * kNB + tx + 8 * j;
          *e -= acc[i][j];
        }
    }
    __syncthreads();
  }

  // ---- inverse, block row by block row -------------------------------------
  for (int bi = 0; bi < nb; ++bi) {
    const int ib = bi * kNB;
    // right-hand sides of block columns k < bi: -sum_{k<=j<bi} L_ij X_jk
    for (int item = tid; item < bi * 64; item += kThreads) {
      const int k = item >> 6;
      const int ty = (item & 63) >> 3, tx = item & 7;
      float acc[kR][kR] = {};
      for (int j = k; j < bi; ++j)
        tile_nn(acc, a, x, ld, ib, k * kNB, j * kNB, ty, tx);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j)
          x[(ib + ty + 8 * i) * ld + k * kNB + tx + 8 * j] = -acc[i][j];
    }
    __syncthreads();
    // every column c of the block row solves against L_ii (the diagonal
    // block's right-hand side is the identity)
    for (int c = tid; c < ib + kNB; c += kThreads) {
      float v[kNB];
#pragma unroll
      for (int r = 0; r < kNB; ++r)
        v[r] = c < ib ? x[(ib + r) * ld + c] : (c - ib == r ? 1.0f : 0.0f);
      solve_col(v, a, rd, ld, ib);
#pragma unroll
      for (int r = 0; r < kNB; ++r) x[(ib + r) * ld + c] = v[r];
    }
    __syncthreads();
  }

  float* Lo = L + ((size_t)t * G + g) * M * M;
  float* Io = Linv + ((size_t)t * G + g) * M * M;
  for (int i = warp; i < M; i += kWarps)
    for (int j = lane; j < M; j += 32) {
      const bool lower = j <= i;
      Lo[(size_t)i * M + j] = lower ? a[i * ld + j] : 0.0f;
      Io[(size_t)i * M + j] = lower ? x[i * ld + j] : 0.0f;
    }
}

// ---- unblocked kernel in device memory (Mp past 160) ----------------------
// Right-looking Cholesky with one rank-1 update per column, then L^-1 by
// forward substitution, one column per thread; in place in the outputs.
__global__ void __launch_bounds__(kThreads)
chol_inv_global(const float* __restrict__ K,
                const float* __restrict__ jitters, float* __restrict__ L,
                float* __restrict__ Linv, int G, int M) {
  const int g = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x;
  const float jit = jitters[t];
  const float* Kg = K + (size_t)g * M * M;
  float* a = L + ((size_t)t * G + g) * M * M;
  float* x = Linv + ((size_t)t * G + g) * M * M;

  for (int i = 0; i < M; ++i)
    for (int j = tid; j < M; j += kThreads)
      a[i * M + j] = Kg[(size_t)i * M + j] + (i == j ? jit : 0.0f);
  __syncthreads();
  for (int k = 0; k < M; ++k) {
    const float d = sqrtf(a[k * M + k]);
    __syncthreads();  // all have read the pivot
    for (int i = k + 1 + tid; i < M; i += kThreads) a[i * M + k] /= d;
    if (tid == 0) a[k * M + k] = d;
    __syncthreads();
    for (int i = k + 1; i < M; ++i)
      for (int j = k + 1 + tid; j <= i; j += kThreads)
        a[i * M + j] = fmaf(-a[i * M + k], a[j * M + k], a[i * M + j]);
    __syncthreads();
  }
  for (int j = tid; j < M; j += kThreads)
    for (int i = j; i < M; ++i) {
      float s = (i == j) ? 1.0f : 0.0f;
      for (int k = j; k < i; ++k) s = fmaf(-a[i * M + k], x[k * M + j], s);
      x[i * M + j] = s / a[i * M + i];
    }
  __syncthreads();
  // each element is read and written by the same thread
  for (int i = 0; i < M; ++i)
    for (int j = tid; j < M; j += kThreads)
      if (j > i) {
        a[i * M + j] = 0.0f;
        x[i * M + j] = 0.0f;
      }
}

}  // namespace k1_chol_inv

using namespace k1_chol_inv;

extern "C" {

// K [G, M, M], jitters [T] -> L, Linv [T, G, M, M]; all f32, contiguous,
// any M.
// Returns the CUDA error code of the launch (0 on success).
int chol_inv_launch(const float* K, const float* jitters, float* L,
                    float* Linv, int G, int T, int M, int device,
                    void* stream) {
  if (G <= 0 || T <= 0 || M <= 0 || T > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, T);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_shared(M)) {
    const size_t smem = smem_bytes(padded(M));
    err = cudaFuncSetAttribute(chol_inv_blocked,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_blocked<<<grid, kThreads, smem, s>>>(K, jitters, L, Linv, G, M);
  } else {
    chol_inv_global<<<grid, kThreads, 0, s>>>(K, jitters, L, Linv, G, M);
  }
  return (int)cudaGetLastError();
}

const char* chol_inv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
