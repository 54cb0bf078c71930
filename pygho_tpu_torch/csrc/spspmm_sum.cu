// K1: the sum contraction of sparse message passing, in its three roles,
//
//     forward:  out[a, :] += U[c, :] * V[d, :]   over triples (a, c, d)
//     dX:       dU[c, :]  += g[a, :] * V[d, :]   over triples (c, a, d)
//     dA:       dV[d, :]  += U[c, :] * g[a, :]   over triples (d, c, a)
//
// Each role is one kernel over triples (t, u, v) sorted by the output row
// t: out[t, :] += L[u, :] * R[v, :], with the triples given as a CSR row
// pointer over the output rows (rowptr) and two index arrays u, v in that
// order.  The host builds each role's order (hodata/loader.py add_rowptr),
// so no role needs atomics.
//
// Replaces the three roles of the TPU kernel
// pygho_tpu/kernels/strip_spspmm.py:_strip_kernel (launched by
// strip_contract on the forward, dX and dA plans of
// build_spspmm_strip_plans).  That kernel gathered rows with one-hot
// matrix products over windows and strips of the operands, because a TPU
// core cannot gather rows by index; a Hopper SM can, so none of that
// design is kept.
//
// What bounds it on an H100: memory.  Each triple reads one row of L and
// one of R (2 * D * 4 bytes) plus 8 bytes of indices and does 2 * D
// floating-point operations, about 0.25 operations a byte, far below the
// roughly 20 operations a byte at which f32 arithmetic would start to
// limit it.  The least traffic is every referenced row of L and R read
// once, the indices read once and every output row written once.
//
// What the design does about it:
// - one warp per output row and the feature dim across the lanes, so a
//   row of L or R is read as one coalesced run (float4 loads, 16 bytes a
//   lane, where D % 4 == 0 and the pointers are 16-byte aligned; a scalar
//   loop otherwise, for any D);
// - the warp loads 32 (u, v) pairs at a time with one coalesced load each
//   and hands them to the lanes by shuffle, so no lane waits on an index
//   load before each gather;
// - the sum of each output row stays in registers and is stored once; rows
//   with no triples store zeros, so the caller allocates the output with
//   torch.empty;
// - no atomics: each row is summed by one warp in triple order, so the
//   result is the same from run to run.  Each product is rounded before
//   it is added (__fmul_rn, __fadd_rn, no fused multiply-add), which is the
//   arithmetic of the plain PyTorch version, L[u] * R[v] summed in order.
// Rows of L and R used by many triples are re-read from L2; keeping them
// in shared memory is left to a later, faster version.  The dX role has
// about two triples a row on the main path, so most of a warp's 32-pair
// index load idles there; that too is left to a later version.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float4 mul_add(float4 acc, float4 u, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(u.x, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(u.y, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(u.z, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(u.w, v.w));
  return acc;
}

__device__ __forceinline__ float mul_add(float acc, float u, float v) {
  return __fadd_rn(acc, __fmul_rn(u, v));
}

__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }

enum Role { kForward, kDX, kDA };

// T is float4 (width = D / 4 vectors a row) or float (width = D); the role
// only names the instance.  U and V are the operands L and R of the role,
// c and d the index arrays u and v of its triples.
template <typename T, Role role>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spspmm_sum_kernel(const T* __restrict__ U, const T* __restrict__ V,
                  const int* __restrict__ c, const int* __restrict__ d,
                  const int* __restrict__ rowptr, T* __restrict__ out,
                  int64_t out_rows, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= out_rows) return;  // whole warp leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int64_t base = 0; base < width; base += 32) {
    const int64_t col = base + lane;
    const bool active = col < width;  // every lane still joins the shuffles
    T acc = zero_of(T());
    for (int t0 = start; t0 < end; t0 += 32) {
      const int n = min(32, end - t0);
      int my_c = 0, my_d = 0;
      if (lane < n) {
        my_c = __ldg(c + t0 + lane);
        my_d = __ldg(d + t0 + lane);
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(kFullMask, my_c, j);
        const int dj = __shfl_sync(kFullMask, my_d, j);
        if (active) {
          const T u = __ldg(U + (int64_t)cj * width + col);
          const T v = __ldg(V + (int64_t)dj * width + col);
          acc = mul_add(acc, u, v);
        }
      }
    }
    if (active) out[row * width + col] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <Role role>
int launch(const float* U, const float* V, const int* c, const int* d,
           const int* rowptr, float* out, int64_t out_rows, int64_t D,
           void* stream) {
  if (out_rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (out_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  if (D % 4 == 0 && aligned16(U) && aligned16(V) && aligned16(out)) {
    spspmm_sum_kernel<float4, role><<<grid, block, 0, s>>>(
        reinterpret_cast<const float4*>(U), reinterpret_cast<const float4*>(V),
        c, d, rowptr, reinterpret_cast<float4*>(out), out_rows, D / 4);
  } else {
    spspmm_sum_kernel<float, role><<<grid, block, 0, s>>>(
        U, V, c, d, rowptr, out, out_rows, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: U: (u_rows, D) f32 and V: (v_rows, D) f32 (the
// role's L and R), c and d: int32[k] row indices into U and V (the role's
// u and v) in output-row order, rowptr:
// int32[out_rows + 1] with rowptr[0] == 0 and rowptr[out_rows] == k, out:
// (out_rows, D) f32.  Every index must be in range: the caller checks them
// on the host.  Returns the cudaGetLastError() of the launch (0 on
// success).

// forward: out[a] += X[c] * A[d] over (a, c, d); U = X, V = A
extern "C" int spspmm_sum_fwd_f32(const float* U, const float* V,
                                  const int* c, const int* d,
                                  const int* rowptr, float* out,
                                  int64_t out_rows, int64_t D,
                                  void* stream) {
  return launch<kForward>(U, V, c, d, rowptr, out, out_rows, D, stream);
}

// dX: dX[c] += g[a] * A[d] over (c, a, d); U = g, V = A
extern "C" int spspmm_sum_dx_f32(const float* U, const float* V,
                                 const int* c, const int* d,
                                 const int* rowptr, float* out,
                                 int64_t out_rows, int64_t D, void* stream) {
  return launch<kDX>(U, V, c, d, rowptr, out, out_rows, D, stream);
}

// dA: dA[d] += X[c] * g[a] over (d, c, a); U = X, V = g
extern "C" int spspmm_sum_da_f32(const float* U, const float* V,
                                 const int* c, const int* d,
                                 const int* rowptr, float* out,
                                 int64_t out_rows, int64_t D, void* stream) {
  return launch<kDA>(U, V, c, d, rowptr, out, out_rows, D, stream);
}
