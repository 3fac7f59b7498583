// Batched Cholesky factor and triangular inverse, one thread block per matrix.
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
// M=128) nor FLOPs (~(2/3) M^3 per matrix), but the chain of M dependent
// pivot steps inside one block: latency. The design keeps the whole working
// set in shared memory (two [M][M+1] f32 arrays, 132 KB at M=128; the +1
// makes column walks bank-conflict free) and runs the G*T independent
// factorizations in parallel, one block each, so the launch costs about one
// matrix's latency. Past M = 168 the two arrays no longer fit in a block's
// 227 KB; the block then works in place in its L and L^-1 outputs in device
// memory (row stride M), with the same steps and the same barriers.
//
// Phase 1, right-looking Cholesky on the lower triangle: per column k, every
// thread reads the pivot, the column below it is divided by sqrt(pivot), and
// the trailing lower triangle takes the rank-1 update.
// Phase 2, inverse by forward substitution: thread j owns column j of L^-1
// (L x = e_j); columns are independent, so this phase needs no barrier.
// All arithmetic is plain f32 (no TF32, no bf16). Outputs carry exact zeros
// above the diagonal by a select, never a multiply (NaN * 0 = NaN).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// True when the block's two [M][M+1] f32 arrays fit in shared memory.
constexpr bool in_shared(int M) { return M <= 168; }

// kShared: the working set lives in shared memory (M <= 168), else in place
// in the outputs; known when compiling, so shared accesses stay shared.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const float* __restrict__ K, const float* __restrict__ jitters,
                float* __restrict__ L, float* __restrict__ Linv, int G,
                int M) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const float jit = jitters[t];
  const float* Kg = K + (size_t)g * M * M;
  float* Lo = L + ((size_t)t * G + g) * M * M;
  float* Io = Linv + ((size_t)t * G + g) * M * M;
  const int ld = kShared ? M + 1 : M;
  float* a = kShared ? smem : Lo;           // K + jitter*I, then L (lower part)
  float* x = kShared ? smem + M * ld : Io;  // L^-1 (lower part)

  for (int idx = tid; idx < M * M; idx += kThreads) {
    const int i = idx / M, j = idx % M;
    const float v = Kg[idx];
    a[i * ld + j] = (i == j) ? v + jit : v;
  }
  __syncthreads();

  // ---- phase 1: right-looking Cholesky ------------------------------------
  for (int k = 0; k < M; ++k) {
    const float d = sqrtf(a[k * ld + k]);  // NaN for a negative pivot
    __syncthreads();                       // all have read the pivot
    for (int i = k + 1 + tid; i < M; i += kThreads) a[i * ld + k] /= d;
    if (tid == 0) a[k * ld + k] = d;
    __syncthreads();
    const int n = M - k - 1;
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int r = idx / n, c = idx % n;
      if (c <= r) {
        const int i = k + 1 + r, j = k + 1 + c;
        a[i * ld + j] = fmaf(-a[i * ld + k], a[j * ld + k], a[i * ld + j]);
      }
    }
    __syncthreads();
  }

  // ---- phase 2: L^-1 by forward substitution, one column per thread -------
  for (int j = tid; j < M; j += kThreads) {
    for (int i = j; i < M; ++i) {
      float s = (i == j) ? 1.0f : 0.0f;
      for (int k = j; k < i; ++k) s = fmaf(-a[i * ld + k], x[k * ld + j], s);
      x[i * ld + j] = s / a[i * ld + i];
    }
  }
  __syncthreads();

  // in place when working in device memory: each element is read and
  // written by the same thread
  for (int idx = tid; idx < M * M; idx += kThreads) {
    const int i = idx / M, j = idx % M;
    const bool lower = j <= i;
    Lo[idx] = lower ? a[i * ld + j] : 0.0f;
    Io[idx] = lower ? x[i * ld + j] : 0.0f;
  }
}

}  // namespace

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
    const size_t smem = 2 * (size_t)M * (M + 1) * sizeof(float);
    err = cudaFuncSetAttribute(chol_inv_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_kernel<true><<<grid, kThreads, smem, s>>>(K, jitters, L, Linv, G,
                                                       M);
  } else {
    chol_inv_kernel<false><<<grid, kThreads, 0, s>>>(K, jitters, L, Linv, G,
                                                     M);
  }
  return (int)cudaGetLastError();
}

const char* chol_inv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
