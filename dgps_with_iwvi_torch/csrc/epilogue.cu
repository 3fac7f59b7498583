// Fused whitened-conditional epilogue (kernel K2): q-variance, prior sum of
// squares and mean in one pass over each tile of A.
//
// Replaces the TPU kernels dgps_with_iwvi_tpu/ops/pallas/qvar.py
// `_epi_kernel` (l.429), `_ps_kernel` (l.437, the mean off) and
// `_qvar_kernel` (l.96, the mean and the sum of squares off). For
// A [L, M, N], W [D, M, M], q_mu [M, D]:
//
//   qv[l, d, n]   = sum_m (W_d^T A_l)[m, n]^2            (root form)
//                 = sum_m A_l[m, n] * (W_d A_l)[m, n]    (covariance form)
//   ss[l, n]      = sum_m A_l[m, n]^2                    (exact f32)
//   mean[l, d, n] = sum_m q_mu[m, d] A_l[m, n]           (bf16x3, `_dot3`)
//
// Rounding follows the TPU kernel (`_qvar_loop` l.417, `_dot3` l.402): the
// quadratic form multiplies W_d and A rounded to bf16 into an f32
// accumulator, then squares (root) or multiplies by the f32 A (cov) and
// sums in f32; the mean splits both operands into bf16 hi/lo halves and
// keeps hi*hi + hi*lo + lo*hi (lo*lo dropped), each product exact in f32.
// Every sum runs in a fixed order and nothing is atomic: the outputs are
// bitwise repeatable.
//
// What bounds it on the H100: at the serving shape (L=100, M=128, N=8192)
// the D=8 inner layer does 2 L D M^2 N = 2.1e11 bf16 tensor-core FLOP
// against 419 MB of A read (0.21 ms of compute vs 0.13 ms of bytes); the
// D=1 final layer is bound by reading A. Beside those, each tile of 128
// columns needs every W_d (32 KB in bf16 at M <= 128) through L2: 1.68 GB
// per serving call at D=8, four times the bytes of A.
//
// The design (sm_90a):
// - Tensor cores by wgmma, in the orientation T^T = A^T Wop^T: each of two
//   consumer warpgroups takes 64 columns n of A as wgmma's 64 rows, the
//   padded M (128 per chunk) is wgmma's N and the reduction k its K
//   (m64n128k16, bf16 in, f32 out). Both operands are K-major in shared
//   memory with the 128-byte swizzle. sum_m then runs over an
//   accumulator's columns: inside a thread and across a quad of lanes, no
//   shared memory and no barrier.
// - W through a ring: `prep_kernel` writes every 128 x 128 block of Wop_d
//   (bf16, W_d^T for the root form) once per call as the swizzled image the
//   wgmma descriptor reads, so one bulk asynchronous copy (cp.async.bulk,
//   the TMA engine) moves a whole 32 KB block into a 2-stage mbarrier ring
//   that one thread of a producer warpgroup keeps full; the warpgroup gives
//   its registers to the consumers (setmaxnreg).
// - Persistent blocks, one per SM, walk the work items (d-split, l, 128
//   column tile). A is copied by cp.async into a swizzled f32 staging tile
//   one item ahead, so the next tile's bytes arrive while this one's
//   products run (in the covariance form, whose epilogue reads the f32 A
//   from the staging tile, after them); it is rounded there once into the
//   bf16 hi (and lo, for the mean) tiles wgmma reads, and the f32 sum of
//   squares is taken on the way.
// - The mean on the tensor cores: per group of 8 outputs, A_hi [q_hi | q_lo]
//   (m64n16k16) and A_lo q_hi (m64n8k16), from q_mu's split that
//   `prep_kernel` writes once per call; (hh + hl) + lh as `_dot3` adds them.
// - Where items are fewer than SMs, the outputs d are split over blocks.
// - Every M: M is worked through in chunks of 128 rows, padded with zeros
//   (zero rows of A and W add nothing); at M <= 128 the chunk loops fold
//   away at compile time. Past 128, A's chunks are staged again per product,
//   the covariance form reads its f32 A from device memory, and the outputs
//   are summed chunk by chunk in place (one owner each).
// - Host side: the shared-memory attribute is set once per process and
//   device, and the device is set only where it is not current.
// Tried and dropped: clusters of 2 blocks sharing each W block by
// TMA multicast (slower: the pair runs in lockstep), two accumulators
// overlapping one output's sums with the next one's products (ptxas then
// serializes the wgmma), turns between the two consumer warpgroups, and a
// loader warpgroup that rounds A into a double buffer (its three warps
// cannot round 64 KB per tile fast enough).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

// The device functions live in a namespace named for the kernel, so
// that a profiler's rows name it (SYMBOLS in ops/hopper/cost.py).
namespace k2_epilogue {

typedef __nv_bfloat16 bf16;

constexpr int kWG = 2;                     // consumer warpgroups
constexpr int kConsumers = kWG * 128;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kTN = kWG * 64;              // columns of A per tile
constexpr int kC = 128;                    // rows of M per chunk (m and k)
constexpr int kStages = 2;                 // W ring
constexpr int kWBytes = kC * kC * 2;       // one bf16 W block
constexpr int kATile = 64 * kC * 2;        // a warpgroup's bf16 A tile
constexpr int kQTile = 16 * kC * 2;        // q_mu's hi and lo, 8 outputs
constexpr int kSTile = kC * 64 * 4;        // a warpgroup's f32 A staging

// shared memory, offsets from a 1024-byte aligned base
constexpr int kOffRing = 0;
constexpr int kOffAhi = kOffRing + kStages * kWBytes;
constexpr int kOffAlo = kOffAhi + kWG * kATile;
constexpr int kOffQ = kOffAlo + kWG * kATile;
constexpr int kOffStage = kOffQ + kWG * kQTile;
constexpr int kOffSs = kOffStage + kWG * kSTile;     // [wg][8][64] f32
constexpr int kOffBar = kOffSs + kWG * 8 * 64 * 4;   // full[], empty[]
constexpr int kSmemUsed = kOffBar + 2 * kStages * 8;
constexpr size_t kSmem = kSmemUsed + 1024;           // for the alignment

__host__ __device__ constexpr int padded_m(int m) {
  return (m + kC - 1) / kC * kC;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

// Arrive at the barrier from lane 0 of the warp only (a predicate, not a
// branch).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.s32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane) : "memory");
}

// Wait for the phase of `parity` to complete. The loop is inside the asm,
// so that the compiler sees no divergent branch around the wgmma that
// follow (it would serialize them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Bulk asynchronous copy (the TMA engine) of `bytes` from global to shared
// memory, completing on the barrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// cp.async of 16 (or 4) bytes, zero-filled past `bytes`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving accesses to `acc` across a wgmma boundary.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&acc)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) asm volatile("" : "+f"(acc[j])::"memory");
}

// Wait until this warpgroup's wgmma groups are done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of a K-major bf16 operand with the 128-byte swizzle: rows of
// 64 k (128 bytes), 8-row groups 1024 bytes apart; `addr` 1024-aligned up
// to the k offset inside the row (+32 bytes per k16 step).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of element (r, k) (k < 64) of a swizzled K-major tile.
__host__ __device__ __forceinline__ int sw128_off(int r, int k) {
  return r * 128 + ((((k >> 3) ^ (r & 7))) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += A B (scale_d = 0: d = A B) for A [64 x 16] and B [16 x 128], bf16
// K-major in shared memory by descriptor, d [64 x 128] f32 in registers.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B (scale_d = 0: d = A B) for A [64 x 16] and B [16 x 16], bf16
// K-major in shared memory by descriptor, d [64 x 16] f32 in registers.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B (scale_d = 0: d = A B) for A [64 x 16] and B [16 x 8], bf16
// K-major in shared memory by descriptor, d [64 x 8] f32 in registers.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The scratch `prep_kernel` writes, in bf16: first every 128 x 128 block
// (d, mc, kc) of Wop_d[m, k] = root ? W[d, k, m] : W[d, m, k] (zeros past
// M) as the swizzled K-major image the ring copies whole, block
// (d * C + mc) * C + kc, two halves of 64 k each [128 m][64 k]; then, per
// group g of 8 outputs and chunk kc, q_mu's split as wgmma's B operand
// [2 halves][16 rows][64 k]: rows 0-7 bf16 hi of q_mu[k, 8g + r], rows 8-15
// the lo parts bf16(q - hi).
__host__ __device__ constexpr long long w_elems(int M, int D) {
  return (long long)D * padded_m(M) * padded_m(M);
}

__host__ __device__ constexpr long long q_elems(int M, int D) {
  return (long long)((D + 7) / 8) * (padded_m(M) / kC) * (kQTile / 2);
}

// One thread writes 8 k (one 16-byte chunk).
__global__ void prep_kernel(const float* __restrict__ W,
                            const float* __restrict__ qmu,
                            bf16* __restrict__ wop, int D, int M, int cov) {
  const int C = padded_m(M) / kC;
  const long long wchunks = w_elems(M, D) / 8;
  const long long total =
      wchunks + (qmu != nullptr ? q_elems(M, D) / 8 : 0);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    bf16 v[8];
    long long off;  // bytes
    if (idx < wchunks) {
      const int c8 = (int)(idx % (kC / 8));  // chunk of 8 k
      const int m = (int)(idx / (kC / 8) % kC);
      const long long blk = idx / (kC / 8) / kC;  // (d * C + mc) * C + kc
      const int kc = (int)(blk % C);
      const int mc = (int)(blk / C % C);
      const int d = (int)(blk / C / C);
      const int mg = mc * kC + m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kg = kc * kC + c8 * 8 + j;
        float w = 0.0f;
        if (mg < M && kg < M)
          w = cov ? W[((size_t)d * M + mg) * M + kg]
                  : W[((size_t)d * M + kg) * M + mg];
        v[j] = __float2bfloat16_rn(w);
      }
      off = blk * kWBytes + (c8 >> 3) * (kWBytes / 2) +
            sw128_off(m, (c8 & 7) * 8);
    } else {
      const long long q = idx - wchunks;
      const int c8 = (int)(q % (kC / 8));
      const int r = (int)(q / (kC / 8) % 16);
      const long long tile = q / (kC / 8) / 16;  // g * C + kc
      const int kc = (int)(tile % C);
      const int d = (int)(tile / C) * 8 + (r & 7);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = kc * kC + c8 * 8 + j;
        const float x = (d < D && m < M) ? qmu[(size_t)m * D + d] : 0.0f;
        const bf16 hi = __float2bfloat16_rn(x);
        v[j] = r < 8 ? hi : __float2bfloat16_rn(x - __bfloat162float(hi));
      }
      off = w_elems(M, D) * 2 + tile * kQTile + (c8 >> 3) * (kQTile / 2) +
            sw128_off(r, (c8 & 7) * 8);
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(wop) + off) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  }
}

// Float index of element (r, n) (n < 64) of a warpgroup's f32 staging tile:
// 16-byte chunks of n swizzled by row, so that the conversion's column reads
// and the covariance epilogue's reads are free of bank conflicts.
__device__ __forceinline__ int st_idx(int r, int n) {
  return r * 64 + ((((n >> 2) ^ (((r >> 1) & 3) << 1))) << 2) + (n & 3);
}

// cp.async of chunk kc of this warpgroup's 64 columns of A_l into its
// staging tile, zeros past M and N (one commit group).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ Al,
                                            int kc, int M, int N, int nw,
                                            uint32_t stg, int t) {
  if ((N & 3) == 0) {
    for (int i = t; i < kC * 16; i += 128) {
      const int r = i >> 4, c = i & 15;
      const int m = kc * kC + r, n = nw + c * 4;
      const bool ok = m < M && n < N;
      cp_async16(stg + 4 * st_idx(r, c * 4),
                 ok ? Al + (size_t)m * N + n : Al, ok ? 16 : 0);
    }
  } else {
    for (int i = t; i < kC * 64; i += 128) {
      const int r = i >> 6, c = i & 63;
      const int m = kc * kC + r, n = nw + c;
      const bool ok = m < M && n < N;
      cp_async4(stg + 4 * st_idx(r, c), ok ? Al + (size_t)m * N + n : Al,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The staged f32 chunk into the warpgroup's bf16 tiles: hi (and lo =
// bf16(a - hi) when kLo), swizzled K-major [2 halves][64 n][64 k]. Thread
// (c4, kg) reads 4 columns n = 4 c4 .. 4 c4 + 3 of the rows 8 kg .. 8 kg + 7
// of each half of k by 16-byte loads, and adds their squares to ssq[j].
template <bool kLo>
__device__ __forceinline__ void convert_chunk(const float* stg, uint8_t* ahi,
                                              uint8_t* alo, int t,
                                              float (&ssq)[4]) {
  const int c4 = t & 15, kg = t >> 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(
          stg + st_idx(64 * h + 8 * kg + r, 4 * c4));
      v[r][0] = x.x;
      v[r][1] = x.y;
      v[r][2] = x.z;
      v[r][3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf16 hi[8], lo[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float a = v[r][j];
        ssq[j] = fmaf(a, a, ssq[j]);
        hi[r] = __float2bfloat16_rn(a);
        if (kLo) lo[r] = __float2bfloat16_rn(a - __bfloat162float(hi[r]));
      }
      const int off = h * (kATile / 2) + sw128_off(4 * c4 + j, kg * 8);
      *reinterpret_cast<uint4*>(ahi + off) = make_uint4(
          pack2(hi[0], hi[1]), pack2(hi[2], hi[3]), pack2(hi[4], hi[5]),
          pack2(hi[6], hi[7]));
      if (kLo)
        *reinterpret_cast<uint4*>(alo + off) = make_uint4(
            pack2(lo[0], lo[1]), pack2(lo[2], lo[3]), pack2(lo[4], lo[5]),
            pack2(lo[6], lo[7]));
    }
  }
}

// acc = A_hi Wop^T over one chunk of k: eight m64n128k16 products.
__device__ __forceinline__ void issue_qform(float (&acc)[64], uint32_t ahi,
                                            uint32_t wst, bool accumulate) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks) {
    const uint32_t ka = (ks >> 2) * (kATile / 2) + (ks & 3) * 32;
    const uint32_t kb = (ks >> 2) * (kWBytes / 2) + (ks & 3) * 32;
    wgmma_n128(acc, sw128_desc(ahi + ka), sw128_desc(wst + kb),
               (accumulate || ks > 0) ? 1 : 0);
  }
  wgmma_commit();
  fence_acc(acc);
}

// Add this thread's part of sum_m to tot0 (row r0) and tot1 (row r0 + 8):
// acc[4j + e] is row r0 (e < 2) or r0 + 8, column m = 8j + 2 t4 + e % 2.
// The covariance form multiplies by the f32 A: from the staging tile
// (`stg`, one chunk) or else from device memory.
__device__ __forceinline__ void qform_sum(const float (&acc)[64], int cov,
                                          const float* stg,
                                          const float* __restrict__ Al,
                                          int mc, int M, int N, int nw,
                                          int r0, int t4, float& tot0,
                                          float& tot1) {
  if (!cov) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      tot0 = fmaf(acc[4 * j], acc[4 * j], tot0);
      tot0 = fmaf(acc[4 * j + 1], acc[4 * j + 1], tot0);
      tot1 = fmaf(acc[4 * j + 2], acc[4 * j + 2], tot1);
      tot1 = fmaf(acc[4 * j + 3], acc[4 * j + 3], tot1);
    }
  } else if (stg != nullptr) {  // zeros past M and N in the staging tile
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t4 + e;
        tot0 = fmaf(stg[st_idx(m, r0)], acc[4 * j + e], tot0);
        tot1 = fmaf(stg[st_idx(m, r0 + 8)], acc[4 * j + 2 + e], tot1);
      }
  } else {
    const int na = nw + r0, nb = na + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mc * kC + 8 * j + 2 * t4 + e;
        if (m < M) {
          const float* row = Al + (size_t)m * N;
          if (na < N) tot0 = fmaf(__ldg(row + na), acc[4 * j + e], tot0);
          if (nb < N) tot1 = fmaf(__ldg(row + nb), acc[4 * j + 2 + e], tot1);
        }
      }
  }
}

// qv[d, n] for this thread's rows from its partial sums: the quad of lanes
// that shares the rows adds its parts in a fixed order.
__device__ __forceinline__ void qform_store(float tot0, float tot1,
                                            float* qv_d, int N, int nw,
                                            int r0, int t4) {
  tot0 += __shfl_xor_sync(0xffffffffu, tot0, 1);
  tot0 += __shfl_xor_sync(0xffffffffu, tot0, 2);
  tot1 += __shfl_xor_sync(0xffffffffu, tot1, 1);
  tot1 += __shfl_xor_sync(0xffffffffu, tot1, 2);
  if (t4 == 0) {
    if (nw + r0 < N) qv_d[nw + r0] = tot0;
    if (nw + r0 + 8 < N) qv_d[nw + r0 + 8] = tot1;
  }
}

// The chunk of k that the i-th product of a (d, mc) pass multiplies: each
// pass starts at the chunk already resident and walks on from it, so the
// producer and the consumers agree on the order of W blocks.
__device__ __forceinline__ int chunk_at(int resident, int i, int C) {
  return (resident + i) % C;
}

struct Item {
  int l, n0, d0, d1;
};

// Work item `it` of a launch: (split z, l, column tile), tiles fastest.
__device__ __forceinline__ Item item_at(int it, int tiles, int L, int D,
                                        int splits) {
  const int tile = it % tiles, rest = it / tiles;
  const int l = rest % L, z = rest / L;
  return {l, tile * kTN, z * D / splits, (z + 1) * D / splits};
}

// Persistent blocks, each over work items it = blockIdx.x + k gridDim.x.
// kOneChunk: M <= 128, one chunk known when compiling.
template <bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1)
epilogue_kernel(const float* __restrict__ A, const bf16* __restrict__ wop,
                float* __restrict__ qv, float* __restrict__ ss,
                float* __restrict__ mean, int L, int M, int D, int N,
                int cov, int tiles, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int C = kOneChunk ? 1 : padded_m(M) / kC;
  const int items = tiles * L * splits;
  const uint32_t ring = smem_u32(sm + kOffRing);
  const uint32_t full = smem_u32(sm + kOffBar);
  const uint32_t empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: W blocks in the consumers' order, through the ring ----
    // (one thread; the warpgroup gives its registers to the consumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      int b = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item w = item_at(it, tiles, L, D, splits);
        int resident = C - 1;
        for (int d = w.d0; d < w.d1; ++d)
          for (int mc = 0; mc < C; ++mc) {
            for (int i = 0; i < C; ++i, ++b) {
              const int kc = chunk_at(resident, i, C);
              const int s = b % kStages;
              mbar_wait(empty + 8 * s, ((b / kStages) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, kWBytes);
              bulk_copy(ring + s * kWBytes,
                        reinterpret_cast<const uint8_t*>(wop) +
                            ((size_t)(d * C + mc) * C + kc) * kWBytes,
                        kWBytes, full + 8 * s);
            }
            resident = chunk_at(resident, C - 1, C);
          }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup per 64 columns of each tile ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // accumulator rows r0, r0 + 8
  uint8_t* ahi = sm + kOffAhi + wg * kATile;
  uint8_t* alo = sm + kOffAlo + wg * kATile;
  uint8_t* qs = sm + kOffQ + wg * kQTile;
  float* stg = reinterpret_cast<float*>(sm + kOffStage + wg * kSTile);
  float* ssp = reinterpret_cast<float*>(sm + kOffSs) + wg * 512;
  const uint32_t ahi_s = smem_u32(ahi), alo_s = smem_u32(alo);
  const uint32_t qs_s = smem_u32(qs), stg_s = smem_u32(stg);
  const uint8_t* qimg =
      reinterpret_cast<const uint8_t*>(wop) + w_elems(M, D) * 2;
  int b = 0;  // W blocks consumed
  int q_resident = -1;  // the q tile (g * C + kc) in qs

  if (kOneChunk && blockIdx.x < items) {
    const Item w = item_at(blockIdx.x, tiles, L, D, splits);
    stage_chunk(A + (size_t)w.l * M * N, 0, M, N, w.n0 + wg * 64, stg_s, t);
  }
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item w = item_at(it, tiles, L, D, splits);
    const float* Al = A + (size_t)w.l * M * N;
    const int nw = w.n0 + wg * 64;  // first column of this warpgroup
    const bool want_ss = ss != nullptr && w.d0 == 0;
    const bool has_next = it + (int)gridDim.x < items;

    // ---- A, the sum of squares and the mean, chunk by chunk --------------
    for (int kc = 0; kc < C; ++kc) {
      if (!kOneChunk) {
        wg_barrier(wg);  // the previous chunk's readers are done
        stage_chunk(Al, kc, M, N, nw, stg_s, t);
      }
      cp_async_wait_all();
      wg_barrier(wg);  // every thread's copies have landed
      float ssq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mean != nullptr)
        convert_chunk<true>(stg, ahi, alo, t, ssq);
      else
        convert_chunk<false>(stg, ahi, alo, t, ssq);
      fence_proxy_async();
      if (want_ss)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ssp[(t >> 4) * 64 + 4 * (t & 15) + j] = ssq[j];
      wg_barrier(wg);  // tiles written, staging read, partials stored
      if (kOneChunk && has_next && !cov) {
        // the next tile's A flies while this one's products run
        const Item nx = item_at(it + gridDim.x, tiles, L, D, splits);
        stage_chunk(A + (size_t)nx.l * M * N, 0, M, N, nx.n0 + wg * 64,
                    stg_s, t);
      }
      if (want_ss && t < 64 && nw + t < N) {
        float v = 0.0f;
#pragma unroll
        for (int kg = 0; kg < 8; ++kg) v += ssp[kg * 64 + t];
        float* out = ss + (size_t)w.l * N + nw + t;
        *out = kc == 0 ? v : *out + v;
      }
      if (mean == nullptr) continue;
      for (int g0 = w.d0 / 8; g0 * 8 < w.d1; ++g0) {
        const int qtile = g0 * C + kc;
        if (qtile != q_resident) {  // kept across tiles where it can be
          wg_barrier(wg);  // the previous q tile is read
          const uint4* src =
              reinterpret_cast<const uint4*>(qimg + (size_t)qtile * kQTile);
          for (int i = t; i < kQTile / 16; i += 128)
            reinterpret_cast<uint4*>(qs)[i] = __ldg(src + i);
          fence_proxy_async();
          wg_barrier(wg);
          q_resident = qtile;
        }
        // [hh | hl] = A_hi [q_hi | q_lo] (n16), lh = A_lo q_hi (n8)
        float hx[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float lh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks) {
          const uint32_t ka = (ks >> 2) * (kATile / 2) + (ks & 3) * 32;
          const uint32_t kb = (ks >> 2) * (kQTile / 2) + (ks & 3) * 32;
          wgmma_n16(hx, sw128_desc(ahi_s + ka), sw128_desc(qs_s + kb),
                    ks > 0);
          wgmma_n8(lh, sw128_desc(alo_s + ka), sw128_desc(qs_s + kb), ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        // rows r0 (e < 2) and r0 + 8; output 8 g0 + 2 t4 + e % 2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = g0 * 8 + 2 * t4 + (e & 1);
          const int n = nw + r0 + (e >> 1) * 8;
          if (d >= w.d0 && d < w.d1 && n < N) {
            const float v = (hx[e] + hx[4 + e]) + lh[e];
            float* out = mean + ((size_t)w.l * D + d) * N + n;
            *out = kc == 0 ? v : *out + v;
          }
        }
      }
    }

    // ---- the quadratic form -----------------------------------------------
    if (kOneChunk) {
      float acc[64];
      const int nd = w.d1 - w.d0;
      for (int i = 0; i < nd; ++i, ++b) {
        const int s = b % kStages;
        mbar_wait(full + 8 * s, (b / kStages) & 1);
        issue_qform(acc, ahi_s, ring + s * kWBytes, false);
        wgmma_wait_all();
        fence_acc(acc);
        __syncwarp();
        mbar_arrive_lane0(empty + 8 * s, lane);
        float tot0 = 0.0f, tot1 = 0.0f;
        qform_sum(acc, cov, stg, Al, 0, M, N, nw, r0, t4, tot0, tot1);
        qform_store(tot0, tot1, qv + ((size_t)w.l * D + w.d0 + i) * N, N,
                    nw, r0, t4);
      }
      if (has_next && cov) {
        wg_barrier(wg);  // every epilogue read of the staging tile is done
        const Item nx = item_at(it + gridDim.x, tiles, L, D, splits);
        stage_chunk(A + (size_t)nx.l * M * N, 0, M, N, nx.n0 + wg * 64,
                    stg_s, t);
      }
    } else {
      int resident = C - 1;
      for (int d = w.d0; d < w.d1; ++d) {
        float tot0 = 0.0f, tot1 = 0.0f;
        for (int mc = 0; mc < C; ++mc) {
          float acc[64];
          const int start = resident;
          for (int i = 0; i < C; ++i, ++b) {
            const int kc = chunk_at(start, i, C);
            if (kc != resident) {
              wg_barrier(wg);
              stage_chunk(Al, kc, M, N, nw, stg_s, t);
              cp_async_wait_all();
              wg_barrier(wg);
              float unused[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              convert_chunk<false>(stg, ahi, alo, t, unused);
              fence_proxy_async();
              wg_barrier(wg);
              resident = kc;
            }
            const int s = b % kStages;
            mbar_wait(full + 8 * s, (b / kStages) & 1);
            issue_qform(acc, ahi_s, ring + s * kWBytes, i > 0);
            wgmma_wait_all();
            __syncwarp();
            mbar_arrive_lane0(empty + 8 * s, lane);
          }
          qform_sum(acc, cov, nullptr, Al, mc, M, N, nw, r0, t4, tot0, tot1);
        }
        qform_store(tot0, tot1, qv + ((size_t)w.l * D + d) * N, N, nw, r0,
                    t4);
      }
    }
  }
}

}  // namespace k2_epilogue

using namespace k2_epilogue;

extern "C" {

// bf16 elements of the scratch `epilogue_launch` takes: W's blocks and,
// for the mean, q_mu's split.
long long epilogue_wop_elems(int M, int D) {
  return w_elems(M, D) + q_elems(M, D);
}

// A [L, M, N], W [D, M, M], q_mu [M, D] (or null) -> qv [L, D, N],
// ss [L, N] (or null), mean [L, D, N] (null iff q_mu is null). wop is
// scratch of epilogue_wop_elems(M, D) bf16, 16-byte aligned. All
// contiguous; any M, D, N. Returns the CUDA error code of the launches (0 on
// success).
int epilogue_launch(const float* A, const float* W, const float* qmu,
                    float* qv, float* ss, float* mean, void* wop, int L,
                    int M, int N, int D, int cov, int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static bool attr_set[kMaxDevices][2] = {};
  static int sms[kMaxDevices] = {};  // SMs of each device, read once
  const long long tiles = (N + kTN - 1) / kTN;
  if (L <= 0 || M <= 0 || N <= 0 || D <= 0 || device < 0 ||
      device >= kMaxDevices || ((qmu == nullptr) != (mean == nullptr)) ||
      (reinterpret_cast<uintptr_t>(wop) & 15) != 0 ||
      tiles * L * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  bf16* Wop = reinterpret_cast<bf16*>(wop);
  const long long chunks = epilogue_wop_elems(M, D) / 8;
  const int blocks = (int)std::min<long long>((chunks + 255) / 256, 1 << 16);
  prep_kernel<<<blocks, 256, 0, s>>>(W, qmu, Wop, D, M, cov);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool one = M <= kC;
  if (!attr_set[device][one]) {
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = one ? cudaFuncSetAttribute(epilogue_kernel<true>, attr, (int)kSmem)
              : cudaFuncSetAttribute(epilogue_kernel<false>, attr, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set[device][one] = true;
  }
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
  }
  // work items (split of d, l, column tile); the outputs d are split where
  // one item per tile would leave SMs idle; one persistent block per SM
  const long long per_split = tiles * L;
  const int splits =
      per_split >= sms[device]
          ? 1
          : std::max(1, std::min(D, (int)(sms[device] / per_split)));
  const int items = (int)(per_split * splits);
  const int grid = std::min(items, sms[device]);
  if (one)
    epilogue_kernel<true><<<grid, kThreads, kSmem, s>>>(
        A, Wop, qv, ss, mean, L, M, D, N, cov, (int)tiles, splits);
  else
    epilogue_kernel<false><<<grid, kThreads, kSmem, s>>>(
        A, Wop, qv, ss, mean, L, M, D, N, cov, (int)tiles, splits);
  return (int)cudaGetLastError();
}

const char* epilogue_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
