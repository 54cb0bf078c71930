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
// parity mode; bf16 products summed in f32 would not, but the sum order
// of an mma is not k ascending), skipping the padded tail of each graph,
// and fusing the zero-fill of the masked entries into the loads.
//
// The bf16 variant (the dense model's bf16 compute, --bf16): each operand
// is stored in f32 or in bf16, a template parameter each, as _cw_kernel
// casts its blocks to f32 (a_ref[0].astype(f32)) whatever they hold:
//     forward  cw_bmm_fwd_bf16:  A and X bf16;
//     dA       cw_bmm_da_bf16:   g f32, X^T bf16 (_cw_bwd takes g in f32);
//     dX       cw_bmm_dx_bf16:   A^T bf16, g f32.
// Every variant writes f32, as _cw_kernel's out_shape is f32.  A bf16
// operand is copied into the ring as its raw 16-bit values (16 bytes =
// 8 channels a cp.async) and widened to f32 where a thread reads it from
// shared memory (an exact shift; widening as it loads would hold each
// copy up behind its conversion), so the products and sums are those
// of the f32 kernel on the widened operands, and the plain version is
// cw_bmm_plain on the widened operands, bit for bit.  A bf16 operand with
// d not contiguous, D % 8 != 0 or a stride or base off 16 bytes has no
// cp.async of its element size (2 bytes): it is loaded and stored to the
// ring by each thread (a slower path for shapes off the main one).
// Bound at the main shape: the operands' bytes shrink, the f32 output
// stays: fwd 2 x 33.6 MB + 67.1 MB = 0.0401 ms, dA and dX 67.1 + 33.6 +
// 67.1 MB = 0.0501 ms at 3.35 TB/s.  Measured (chip_smoke.py, H100 SXM):
// fwd 51% of its bound (the f32 store is half its bytes), dA and dX
// 67-68%, with 128 registers and no spills on the 16-byte path.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the raw bits of a bf16 value, as the wrapper hands torch.bfloat16 data
using bf16_bits = uint16_t;

constexpr int kTD = 16;              // channels of a block, 4 a thread
constexpr int kTI = 32;              // rows of i of a block
constexpr int kTJ = 32;              // columns of j of a block
constexpr int kKC = 4;               // values of k a stage
constexpr int kStages = 4;           // stages of the ring
constexpr int kThreads = 256;
constexpr int kRI = 4;               // rows of i of a thread, 8 apart
constexpr int kRJ = 4;               // columns of j of a thread, 8 apart
// a stage: A as [kKC][kTI][kTD] values of its stored type, then X as
// [kKC][kTJ][kTD] values of its own
constexpr int kStageVals = kKC * kTI * kTD;
static_assert(kTI == 8 * kRI && kTJ == 8 * kRJ, "8 x 8 threads an (i, j)");
static_assert(kTI == kTJ, "a stage's A and X parts have one layout");
static_assert(kThreads == 8 * 8 * (kTD / 4), "a thread a (quad, i, j) slot");
static_assert(kStageVals % (8 * kThreads) == 0,
              "a stage splits evenly over the threads, 16 bytes a copy");

template <typename TA, typename TX>
constexpr size_t smem_bytes() {
  return (size_t)kStages * kStageVals * (sizeof(TA) + sizeof(TX));
}

enum Role { kForward, kDA, kDX };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES (16 or 4) from src to shared memory, or zeros where !valid
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
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

// four consecutive channels from the ring, widened to f32 (a bf16 value
// is the high half of its f32: an exact shift)
__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const bf16_bits* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ float4 mul_add(float4 acc, float4 a, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(a.x, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(a.y, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(a.z, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(a.w, x.w));
  return acc;
}

// one operand's part of stage k0: dst[kk][r][c] = P[row0 + r, k0 + kk,
// d0 + c] (row: i for A, j for X) through the strides s_r, s_k, s_d, or 0
// out of range.  VEC: 16-byte cp.async copies (4 f32 or 8 bf16 channels),
// consecutive threads on consecutive 16 bytes of shared memory; else one
// value a copy: a 4-byte cp.async for f32, a load and a store for bf16.
template <typename T, bool VEC>
__device__ __forceinline__ void fetch_operand(T* dst, const T* P,
                                              int64_t s_r, int64_t s_k,
                                              int64_t s_d, int row0, int k0,
                                              int d0, int n, int D, int t) {
  constexpr int W = VEC ? 16 / (int)sizeof(T) : 1;
  constexpr int kPer = kStageVals / W / kThreads;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int e = t + m * kThreads;           // in units of W values
    const int c = (e % (kTD / W)) * W;        // channel in the slice
    const int r = (e / (kTD / W)) % kTI;      // i (A) or j (X)
    const int kk = e / (kTD / W) / kTI;
    const int d = d0 + c, k = k0 + kk, row = row0 + r;
    const bool ok = d < D && k < n && row < n;
    const T* src = ok ? P + row * s_r + k * s_k + (int64_t)d * s_d : P;
    if constexpr (VEC || sizeof(T) == 4) {
      copy_async<VEC ? 16 : 4>(dst + e * W, src, ok);
    } else {
      dst[e] = ok ? *src : T(0);
    }
  }
}

// A is read as A[b, i, k, d] and X as X[b, k, j, d], each through its
// strides; out is (B, n, n, D) f32 contiguous.  VEC: d is contiguous in
// both operands, D a multiple of each operand's 16-byte copy, and every
// other stride and all three bases 16-byte aligned, so a copy takes 16
// bytes and a store 4 channels.
template <typename TA, typename TX, bool VEC, Role role>
__global__ void __launch_bounds__(kThreads, 2)
cw_bmm_kernel(const TA* __restrict__ A, int64_t a_sb, int64_t a_si,
              int64_t a_sk, int64_t a_sd, const TX* __restrict__ X,
              int64_t x_sb, int64_t x_sk, int64_t x_sj, int64_t x_sd,
              float* __restrict__ out, int n, int D, int tiles_j,
              int tiles_d) {
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr size_t kStageBytes =
      (size_t)kStageVals * (sizeof(TA) + sizeof(TX));
  const int t = threadIdx.x;
  // consecutive blocks take neighbouring channel slices of one tile
  const int tile = blockIdx.x / tiles_d;
  const int d0 = (blockIdx.x % tiles_d) * kTD;
  const int i0 = (tile / tiles_j) * kTI;
  const int j0 = (tile % tiles_j) * kTJ;
  const int64_t b = blockIdx.y;
  const TA* Ab = A + b * a_sb;
  const TX* Xb = X + b * x_sb;

  auto stage_a = [&](int slot) {
    return reinterpret_cast<TA*>(ring + slot * kStageBytes);
  };
  auto stage_x = [&](int slot) {
    return reinterpret_cast<TX*>(ring + slot * kStageBytes +
                                 kStageVals * sizeof(TA));
  };
  // stage `slot` <- k in [k0, k0 + kKC)
  auto fetch = [&](int slot, int k0) {
    fetch_operand<TA, VEC>(stage_a(slot), Ab, a_si, a_sk, a_sd, i0, k0, d0,
                           n, D, t);
    fetch_operand<TX, VEC>(stage_x(slot), Xb, x_sj, x_sk, x_sd, j0, k0, d0,
                           n, D, t);
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
    const TA* sA = stage_a(ch % kStages);
    const TX* sX = stage_x(ch % kStages);
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float4 a[kRI];
#pragma unroll
      for (int r = 0; r < kRI; ++r)
        a[r] = read4(sA + (kk * kTI + ib + 8 * r) * kTD + 4 * q);
#pragma unroll
      for (int c = 0; c < kRJ; ++c) {
        const float4 x = read4(sX + (kk * kTJ + jb + 8 * c) * kTD + 4 * q);
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

// an operand can take 16-byte copies: d contiguous, D a whole number of
// copies, the other strides and the base on 16 bytes
template <typename T>
bool vec_ok(const T* P, int64_t s0, int64_t s1, int64_t s2, int64_t s_d,
            int64_t D) {
  constexpr int64_t W = 16 / sizeof(T);
  return s_d == 1 && D % W == 0 && (s0 | s1 | s2) % W == 0 && aligned16(P);
}

template <typename TA, typename TX, bool VEC, Role role>
int run(const TA* A, int64_t a_sb, int64_t a_si, int64_t a_sk,
        int64_t a_sd, const TX* X, int64_t x_sb, int64_t x_sk,
        int64_t x_sj, int64_t x_sd, float* out, int64_t n, int64_t D,
        int64_t tiles_j, int64_t tiles_d, const dim3& grid, cudaStream_t s) {
  constexpr size_t kSmem = smem_bytes<TA, TX>();
  const cudaError_t e = cudaFuncSetAttribute(
      cw_bmm_kernel<TA, TX, VEC, role>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  cw_bmm_kernel<TA, TX, VEC, role><<<grid, kThreads, kSmem, s>>>(
      A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk, x_sj, x_sd, out, (int)n,
      (int)D, (int)tiles_j, (int)tiles_d);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX, Role role>
int launch(const void* Av, int64_t a_sb, int64_t a_si, int64_t a_sk,
           int64_t a_sd, const void* Xv, int64_t x_sb, int64_t x_sk,
           int64_t x_sj, int64_t x_sd, float* out, int64_t B, int64_t n,
           int64_t D, void* stream) {
  const TA* A = static_cast<const TA*>(Av);
  const TX* X = static_cast<const TX*>(Xv);
  if (B <= 0 || n <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (n > 0x7fffffffLL || D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_i = (n + kTI - 1) / kTI, tiles_j = (n + kTJ - 1) / kTJ;
  const int64_t tiles = tiles_i * tiles_j, tiles_d = (D + kTD - 1) / kTD;
  if (tiles > 0x7fffffffLL / tiles_d || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(tiles * tiles_d), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(A, a_sb, a_si, a_sk, a_sd, D) &&
                   vec_ok(X, x_sb, x_sk, x_sj, x_sd, D) && aligned16(out);
  return vec ? run<TA, TX, true, role>(A, a_sb, a_si, a_sk, a_sd, X, x_sb,
                                       x_sk, x_sj, x_sd, out, n, D, tiles_j,
                                       tiles_d, grid, s)
             : run<TA, TX, false, role>(A, a_sb, a_si, a_sk, a_sd, X, x_sb,
                                        x_sk, x_sj, x_sd, out, n, D, tiles_j,
                                        tiles_d, grid, s);
}

}  // namespace

// Every entry point: A read as A[b, i, k, d] through the strides a_sb,
// a_si, a_sk, a_sd and X as X[b, k, j, d] through x_sb, x_sk, x_sj, x_sd
// (in elements, each >= 0), both of extents (B, n, n, D), each f32 or
// bf16 as the entry point's name and comment say; out: (B, n, n, D) f32,
// contiguous, written in full.  Returns the cudaGetLastError() of the
// launch (0 on success).
#define CW_ENTRY(NAME, TA, TX, ROLE)                                        \
  extern "C" int NAME(const void* A, int64_t a_sb, int64_t a_si,            \
                      int64_t a_sk, int64_t a_sd, const void* X,            \
                      int64_t x_sb, int64_t x_sk, int64_t x_sj,             \
                      int64_t x_sd, float* out, int64_t B, int64_t n,       \
                      int64_t D, void* stream) {                            \
    return launch<TA, TX, ROLE>(A, a_sb, a_si, a_sk, a_sd, X, x_sb, x_sk,   \
                                x_sj, x_sd, out, B, n, D, stream);          \
  }

// forward: out = cw(A, X)
CW_ENTRY(cw_bmm_fwd_f32, float, float, kForward)
// dA = cw(g, X^T): A = g, X = the forward's X with its n axes swapped
CW_ENTRY(cw_bmm_da_f32, float, float, kDA)
// dX = cw(A^T, g): A = the forward's A with its n axes swapped, X = g
CW_ENTRY(cw_bmm_dx_f32, float, float, kDX)
// the bf16 variant: the forward on bf16 A and X
CW_ENTRY(cw_bmm_fwd_bf16, bf16_bits, bf16_bits, kForward)
// dA on an f32 cotangent g and a bf16 X^T
CW_ENTRY(cw_bmm_da_bf16, float, bf16_bits, kDA)
// dX on a bf16 A^T and an f32 cotangent g
CW_ENTRY(cw_bmm_dx_bf16, bf16_bits, float, kDX)
