// K5: the channel-wise batched matrix product of the dense (masked) mode,
//
//     out[b, i, j, d] = sum over k of A[b, i, k, d] * X[b, k, j, d]
//
// an independent (n, n) x (n, n) product for every graph b and channel d,
// in its three roles:
//
//     forward:  out = cw(A, X)
//     dA:       dA  = cw(g, X^T)     dA[b,i,k,d] = sum_j g[b,i,j,d] X[b,k,j,d]
//     dX:       dX  = cw(A^T, g)     dX[b,k,j,d] = sum_i A[b,i,k,d] g[b,i,j,d]
//
// where ^T swaps the two n axes.  Each operand comes as a base pointer and
// its four strides (in elements), so a transposed operand is a strided
// view and no role copies one.  The output is written contiguous
// (b, n, n, d).  It carries the PPGN/2-FWL product and every within-
// subgraph product of the dense ("DD") mode (backend/mamamm.py).
//
// Replaces the TPU kernel pygho_tpu/kernels/channelwise_bmm.py:_cw_kernel
// (launched by _cw_bmm_raw, the forward; _cw_bwd runs it for dA and dX).
// That kernel took one whole graph a grid step, kept d on the 128 lanes of
// the TPU's vector unit and unrolled k; what it computes is kept, its
// unrolling is not.
//
// What bounds it on an H100: memory.  At the main shape (128, 32, 32, 128)
// f32, each of A, X and out is 67,108,864 bytes: 201.3 MB moved at least,
// 0.0601 ms at 3.35 TB/s, against 2 * b * n^3 * d = 1.074 GFLOP, 0.016 ms
// at 67 TFLOP/s of f32 with fused multiply-adds.  The kernel multiplies
// and adds separately (below), so its arithmetic issues as 1.074 G f32
// instructions, about 0.03 ms of the FP32 pipes: under the byte bound, so
// long as loads stay in flight while it runs and shared memory feeds the
// pipes.
//
// The design:
// - one block per (b, 32 x 32 tile of (i, j), 16 channels of d): at n <=
//   32 a block owns all of a graph's n x n for its channels, so each
//   operand is read from device memory once (a first version, with 16
//   rows of i a block, read X twice at n = 32: 268 MB for 201);
// - k runs through a ring of kStages stages in shared memory, kKC values
//   of k a stage: A[i0:i0+32, k, slice] and X[k, j0:j0+32, slice], copied
//   by cp.async (16 bytes a copy where d is contiguous and everything is
//   16-byte aligned, 4 bytes otherwise), out-of-range entries zero-filled
//   by the copy itself; kStages - 1 stages are in flight while one is
//   summed, and one barrier a stage both publishes the stage that landed
//   and frees the one summed before (a first version kept one stage in
//   registers behind two barriers a stage);
// - each thread keeps a 4 (i) x 4 (j) x 4 (channels) tile of sums in
//   registers and reads shared memory 16 bytes (4 channels) at a time: 8
//   reads feed 64 products, and a warp's reads of one k touch 2 rows of
//   A and 4 of X, so the FP32 pipes, not the shared-memory port, set the
//   arithmetic's pace;
// - k is summed in ascending order and each product is rounded before it
//   is added (__fmul_rn, __fadd_rn, no fused multiply-add), the order and
//   arithmetic of _cw_kernel and of the plain PyTorch version, which the
//   kernel therefore matches bit for bit; a zero-filled k past n adds +0,
//   which leaves a sum that starts at +0 unchanged;
// - no atomics: each output is summed by one thread, so the result is the
//   same from run to run.
// Measured at the main shape (chip_smoke.py): 68-70% of the byte bound
// in every role, with the 16-byte path at 128 registers and no spills.
// Left to a faster version: the tensor cores (TF32 would break the f32
// parity mode; bf16 operands come with K5's bf16 variant), skipping the
// padded tail of each graph, and fusing the zero-fill of the masked
// entries into the loads.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 16;              // channels of a block, 4 a thread
constexpr int kQuads = kTD / 4;      // float4 quads of a block's channels
constexpr int kTI = 32;              // rows of i of a block
constexpr int kTJ = 32;              // columns of j of a block
constexpr int kKC = 4;               // values of k a stage
constexpr int kStages = 4;           // stages of the ring
constexpr int kThreads = 256;
constexpr int kRI = 4;               // rows of i of a thread, 8 apart
constexpr int kRJ = 4;               // columns of j of a thread, 8 apart
// a stage: A as [kKC][kTI][kTD] floats, then X as [kKC][kTJ][kTD]
constexpr int kStageA = kKC * kTI * kTD;
constexpr int kStageFloats = kStageA + kKC * kTJ * kTD;
constexpr size_t kSmemBytes = (size_t)kStages * kStageFloats * sizeof(float);
static_assert(kTI == 8 * kRI && kTJ == 8 * kRJ, "8 x 8 threads an (i, j)");
static_assert(kTI == kTJ, "a stage's A and X parts have one layout");
static_assert(kThreads == 8 * 8 * kQuads, "a thread a (quad, i, j) slot");
static_assert(kStageA % (4 * kThreads) == 0 &&
              (kStageFloats - kStageA) % (4 * kThreads) == 0,
              "a stage splits evenly over the threads");

enum Role { kForward, kDA, kDX };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES (16 or 4) from src to shared memory, or zeros where !valid
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const int n = valid ? BYTES : 0;
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 mul_add(float4 acc, float4 a, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(a.x, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(a.y, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(a.z, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(a.w, x.w));
  return acc;
}

// A is read as A[b, i, k, d] and X as X[b, k, j, d], each through its
// strides; out is (B, n, n, D) contiguous.  VEC: d is contiguous, D % 4 ==
// 0 and every other stride and both bases 16-byte aligned, so a copy and a
// store take 4 channels.
template <bool VEC, Role role>
__global__ void __launch_bounds__(kThreads, 2)
cw_bmm_kernel(const float* __restrict__ A, int64_t a_sb, int64_t a_si,
              int64_t a_sk, int64_t a_sd, const float* __restrict__ X,
              int64_t x_sb, int64_t x_sk, int64_t x_sj, int64_t x_sd,
              float* __restrict__ out, int n, int D, int tiles_j,
              int tiles_d) {
  extern __shared__ __align__(16) float ring[];
  const int t = threadIdx.x;
  // consecutive blocks take neighbouring channel slices of one tile
  const int tile = blockIdx.x / tiles_d;
  const int d0 = (blockIdx.x % tiles_d) * kTD;
  const int i0 = (tile / tiles_j) * kTI;
  const int j0 = (tile % tiles_j) * kTJ;
  const int64_t b = blockIdx.y;
  const float* Ab = A + b * a_sb;
  const float* Xb = X + b * x_sb;

  // stage `slot` <- k in [k0, k0 + kKC); a thread copies kStageA /
  // kThreads floats of each operand, consecutive threads consecutive
  // 16 (VEC) or 4 bytes of shared memory
  auto fetch = [&](int slot, int k0) {
    float* sA = ring + slot * kStageFloats;
    float* sX = sA + kStageA;
    constexpr int W = VEC ? 4 : 1;
    constexpr int kPer = kStageA / W / kThreads;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = t + m * kThreads;           // in units of W floats
      const int c = (e % (kTD / W)) * W;        // channel in the slice
      const int r = (e / (kTD / W)) % kTI;      // i (A) or j (X)
      const int kk = e / (kTD / W) / kTI;
      const int d = d0 + c, k = k0 + kk;
      const bool ok = d < D && k < n;
      const int i = i0 + r, j = j0 + r;
      copy_async<4 * W>(sA + e * W,
                        ok && i < n
                            ? Ab + i * a_si + k * a_sk + (int64_t)d * a_sd
                            : A,
                        ok && i < n);
      copy_async<4 * W>(sX + e * W,
                        ok && j < n
                            ? Xb + k * x_sk + j * x_sj + (int64_t)d * x_sd
                            : X,
                        ok && j < n);
    }
  };

  // this thread's outputs: channels 4q..4q+3 of the slice, rows ib + 8r
  // and columns jb + 8c of the tile; a warp is 4 quads x 2 rows x 4
  // columns, so its reads of one k are 2 rows of A and 4 of X
  const int q = t & 3;
  const int warp = t >> 5;
  const int ib = (warp & 3) * 2 + ((t >> 2) & 1);
  const int jb = (warp >> 2) * 4 + ((t >> 3) & 3);
  float4 acc[kRI][kRJ];
#pragma unroll
  for (int r = 0; r < kRI; ++r)
#pragma unroll
    for (int c = 0; c < kRJ; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int chunks = (n + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) fetch(s, s * kKC);
    commit();  // one group a stage, empty past the last
  }
  for (int ch = 0; ch < chunks; ++ch) {
    wait_pending<kStages - 2>();  // this thread's copies of chunk ch landed
    __syncthreads();  // everyone's landed, and chunk ch - 1's slot is free
    const int next = ch + kStages - 1;
    if (next < chunks) fetch(next % kStages, next * kKC);
    commit();
    const float4* sA =
        reinterpret_cast<const float4*>(ring + (ch % kStages) * kStageFloats);
    const float4* sX = sA + kStageA / 4;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float4 a[kRI];
#pragma unroll
      for (int r = 0; r < kRI; ++r)
        a[r] = sA[(kk * kTI + ib + 8 * r) * kQuads + q];
#pragma unroll
      for (int c = 0; c < kRJ; ++c) {
        const float4 x = sX[(kk * kTJ + jb + 8 * c) * kQuads + q];
#pragma unroll
        for (int r = 0; r < kRI; ++r) acc[r][c] = mul_add(acc[r][c], a[r], x);
      }
    }
  }

  const int d = d0 + 4 * q;
  if (d >= D) return;
#pragma unroll
  for (int r = 0; r < kRI; ++r) {
    const int i = i0 + ib + 8 * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < kRJ; ++c) {
      const int j = j0 + jb + 8 * c;
      if (j >= n) continue;
      float* o = out + ((b * n + i) * n + j) * (int64_t)D + d;
      if (VEC) {
        *reinterpret_cast<float4*>(o) = acc[r][c];
      } else {
        const float v[4] = {acc[r][c].x, acc[r][c].y, acc[r][c].z,
                            acc[r][c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) o[e] = v[e];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool VEC, Role role>
int run(const float* A, int64_t a_sb, int64_t a_si, int64_t a_sk,
        int64_t a_sd, const float* X, int64_t x_sb, int64_t x_sk,
        int64_t x_sj, int64_t x_sd, float* out, int64_t n, int64_t D,
        int64_t tiles_j, int64_t tiles_d, const dim3& grid, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      cw_bmm_kernel<VEC, role>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cw_bmm_kernel<VEC, role><<<grid, kThreads, kSmemBytes, s>>>(
      A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj, x_sd, out, (int)n,
      (int)D, (int)tiles_j, (int)tiles_d);
  return (int)cudaGetLastError();
}

template <Role role>
int launch(const float* A, int64_t a_sb, int64_t a_si, int64_t a_sk,
           int64_t a_sd, const float* X, int64_t x_sb, int64_t x_sk,
           int64_t x_sj, int64_t x_sd, float* out, int64_t B, int64_t n,
           int64_t D, void* stream) {
  if (B <= 0 || n <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (n > 0x7fffffffLL || D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_i = (n + kTI - 1) / kTI, tiles_j = (n + kTJ - 1) / kTJ;
  const int64_t tiles = tiles_i * tiles_j, tiles_d = (D + kTD - 1) / kTD;
  if (tiles > 0x7fffffffLL / tiles_d || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(tiles * tiles_d), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && a_sd == 1 && x_sd == 1 &&
                   (a_sb | a_si | a_sk | x_sb | x_sk | x_sj) % 4 == 0 &&
                   aligned16(A) && aligned16(X) && aligned16(out);
  return vec ? run<true, role>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk,
                               x_sj, x_sd, out, n, D, tiles_j, tiles_d,
                               grid, s)
             : run<false, role>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk,
                                x_sj, x_sd, out, n, D, tiles_j, tiles_d,
                                grid, s);
}

}  // namespace

// Every entry point: A read as A[b, i, k, d] through the strides a_sb,
// a_si, a_sk, a_sd and X as X[b, k, j, d] through x_sb, x_sk, x_sj, x_sd
// (in elements, each >= 0), both f32 of extents (B, n, n, D); out: (B, n,
// n, D) f32, contiguous, written in full.  Returns the cudaGetLastError()
// of the launch (0 on success).

// forward: out = cw(A, X)
extern "C" int cw_bmm_fwd_f32(const float* A, int64_t a_sb, int64_t a_si,
                              int64_t a_sk, int64_t a_sd, const float* X,
                              int64_t x_sb, int64_t x_sk, int64_t x_sj,
                              int64_t x_sd, float* out, int64_t B, int64_t n,
                              int64_t D, void* stream) {
  return launch<kForward>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj,
                          x_sd, out, B, n, D, stream);
}

// dA = cw(g, X^T): A = g, X = the forward's X with its n axes swapped
extern "C" int cw_bmm_da_f32(const float* A, int64_t a_sb, int64_t a_si,
                             int64_t a_sk, int64_t a_sd, const float* X,
                             int64_t x_sb, int64_t x_sk, int64_t x_sj,
                             int64_t x_sd, float* out, int64_t B, int64_t n,
                             int64_t D, void* stream) {
  return launch<kDA>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj, x_sd,
                     out, B, n, D, stream);
}

// dX = cw(A^T, g): A = the forward's A with its n axes swapped, X = g
extern "C" int cw_bmm_dx_f32(const float* A, int64_t a_sb, int64_t a_si,
                             int64_t a_sk, int64_t a_sd, const float* X,
                             int64_t x_sb, int64_t x_sk, int64_t x_sj,
                             int64_t x_sd, float* out, int64_t B, int64_t n,
                             int64_t D, void* stream) {
  return launch<kDX>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj, x_sd,
                     out, B, n, D, stream);
}
