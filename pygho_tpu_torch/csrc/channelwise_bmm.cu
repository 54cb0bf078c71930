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
// at 67 TFLOP/s of f32 outside the tensor cores.
//
// What the design does about it (a simple first version):
// - one block per (b, 16 rows of i, 32 columns of j, 32 channels of d);
//   each of the 8 warps of a block owns 2 rows of i and all 32 columns, one
//   channel a lane, so a thread keeps 64 sums in registers;
// - d across the lanes: every global load and store of a warp is 32
//   neighbouring channels, one coalesced 128-byte run where the d stride
//   is 1 (it is in every role: the roles swap n axes only);
// - the block's rows of A and columns of X are staged in shared memory,
//   4 values of k at a time, so each value read from device memory is used
//   by 32 (A) or 16 (X) products; every shared-memory access is
//   bank-conflict free;
// - a thread issues all its loads of a stage at once, into registers, and
//   the next stage's loads are in flight while the current one is summed:
//   a first version that loaded and stored one value at a time waited out
//   the latency of device memory some 24 times a stage and took 0.35 ms at
//   the main shape;
// - k is summed in ascending order and each product is rounded before it
//   is added (__fmul_rn, __fadd_rn, no fused multiply-add), the order and
//   arithmetic of _cw_kernel and of the plain PyTorch version, which the
//   kernel therefore matches bit for bit;
// - no atomics: each output is summed by one thread, so the result is the
//   same from run to run.
// Left to a faster version: the tensor cores (TF32 or bf16 operands),
// skipping the padded tail of each graph, and fusing the zero-fill of the
// masked entries into the loads.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 32;              // channels of a block, one a lane
constexpr int kWarps = 8;            // warps of a block
constexpr int kRI = 2;               // rows of i of a warp
constexpr int kTI = kWarps * kRI;    // rows of i of a block
constexpr int kTJ = 32;              // columns of j of a block
constexpr int kKC = 4;               // values of k staged at a time
constexpr int kALoads = kTI * kKC / kWarps;   // A values a thread stages
constexpr int kXLoads = kKC * kTJ / kWarps;   // X values a thread stages
static_assert(kTI * kKC % kWarps == 0 && kKC * kTJ % kWarps == 0,
              "a stage splits evenly over the warps");

enum Role { kForward, kDA, kDX };

// A is read as A[b, i, k, d] and X as X[b, k, j, d], each through its
// strides; out is (B, n, n, D) contiguous.
template <Role role>
__global__ void __launch_bounds__(kTD * kWarps)
cw_bmm_kernel(const float* __restrict__ A, int64_t a_sb, int64_t a_si,
              int64_t a_sk, int64_t a_sd, const float* __restrict__ X,
              int64_t x_sb, int64_t x_sk, int64_t x_sj, int64_t x_sd,
              float* __restrict__ out, int n, int D, int tiles_j) {
  __shared__ float sA[kTI][kKC][kTD];
  __shared__ float sX[kKC][kTJ][kTD];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int i0 = (blockIdx.x / tiles_j) * kTI;
  const int j0 = (blockIdx.x % tiles_j) * kTJ;
  const int d = blockIdx.y * kTD + lane;
  const bool d_ok = d < D;   // every lane still joins the barriers
  const int64_t b = blockIdx.z;
  const float* Ab = A + b * a_sb + (d_ok ? d * a_sd : 0);
  const float* Xb = X + b * x_sb + (d_ok ? d * x_sd : 0);

  // this thread's share of a stage: kALoads values of A and kXLoads of X,
  // each load of a warp 32 neighbouring channels of one (i, k) or (k, j)
  float ra[kALoads], rx[kXLoads];
  auto fetch = [&](int k0) {
    const int kc = min(kKC, n - k0);
#pragma unroll
    for (int q = 0; q < kALoads; ++q) {
      const int p = warp + q * kWarps, r = p / kKC, kk = p % kKC;
      const int i = i0 + r;
      ra[q] = (d_ok && i < n && kk < kc)
          ? __ldg(Ab + i * a_si + (k0 + kk) * a_sk) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      const int p = warp + q * kWarps, kk = p / kTJ, c = p % kTJ;
      const int j = j0 + c;
      rx[q] = (d_ok && j < n && kk < kc)
          ? __ldg(Xb + (k0 + kk) * x_sk + j * x_sj) : 0.f;
    }
  };

  float acc[kRI][kTJ];
#pragma unroll
  for (int r = 0; r < kRI; ++r)
#pragma unroll
    for (int c = 0; c < kTJ; ++c) acc[r][c] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < n; k0 += kKC) {
    const int kc = min(kKC, n - k0);
    // the stage A[i0 : i0 + kTI, k0 : k0 + kc], X[k0 : k0 + kc, j0 : j0 +
    // kTJ] for this block's channels goes to shared memory; out-of-range
    // entries are 0 and are never summed (the k loop below stops at kc,
    // the stores at n)
#pragma unroll
    for (int q = 0; q < kALoads; ++q) {
      const int p = warp + q * kWarps;
      sA[p / kKC][p % kKC][lane] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      const int p = warp + q * kWarps;
      sX[p / kTJ][p % kTJ][lane] = rx[q];
    }
    __syncthreads();
    // the next stage's loads are in flight while this one is summed
    if (k0 + kKC < n) fetch(k0 + kKC);
    for (int kk = 0; kk < kc; ++kk) {
      float a[kRI];
#pragma unroll
      for (int r = 0; r < kRI; ++r) a[r] = sA[warp * kRI + r][kk][lane];
#pragma unroll
      for (int c = 0; c < kTJ; ++c) {
        const float x = sX[kk][c][lane];
#pragma unroll
        for (int r = 0; r < kRI; ++r)
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(a[r], x));
      }
    }
    __syncthreads();
  }

  if (!d_ok) return;
#pragma unroll
  for (int r = 0; r < kRI; ++r) {
    const int i = i0 + warp * kRI + r;
    if (i >= n) continue;
    float* row = out + ((b * n + i) * n) * (int64_t)D + d;
#pragma unroll
    for (int c = 0; c < kTJ; ++c) {
      const int j = j0 + c;
      if (j < n) row[(int64_t)j * D] = acc[r][c];
    }
  }
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
  if (tiles > 0x7fffffffLL || tiles_d > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)tiles_d, (unsigned)B);
  const dim3 block(kTD, kWarps);
  cw_bmm_kernel<role><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj, x_sd, out, (int)n,
      (int)D, (int)tiles_j);
  return (int)cudaGetLastError();
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
