// K1 forward: the sum contraction of sparse message passing,
//
//     out[a, :] = sum over triples (a, c, d) of U[c, :] * V[d, :]
//
// with the triples sorted by a and given as a CSR row pointer over the
// output rows (rowptr) and two index arrays c, d in that order.
//
// Replaces the forward role of the TPU kernel
// pygho_tpu/kernels/strip_spspmm.py:_strip_kernel (launched by
// strip_contract).  That kernel gathered rows with one-hot matrix products
// over windows and strips of the operands, because a TPU core cannot
// gather rows by index; a Hopper SM can, so none of that design is kept.
//
// What bounds it on an H100: memory.  Each triple reads one row of U and
// one of V (2 * D * 4 bytes) plus 8 bytes of indices and does 2 * D
// floating-point operations, about 0.25 operations a byte, far below the
// roughly 20 operations a byte at which f32 arithmetic would start to
// limit it.  The least traffic is every referenced row of U and V read
// once, the indices read once and every output row written once.
//
// What the design does about it:
// - one warp per output row and the feature dim across the lanes, so a
//   row of U or V is read as one coalesced run (float4 loads, 16 bytes a
//   lane, where D % 4 == 0 and the pointers are 16-byte aligned; a scalar
//   loop otherwise, for any D);
// - the warp loads 32 (c, d) pairs at a time with one coalesced load each
//   and hands them to the lanes by shuffle, so no lane waits on an index
//   load before each gather;
// - the sum of each output row stays in registers and is stored once; rows
//   with no triples store zeros, so the caller allocates the output with
//   torch.empty;
// - no atomics: each row is summed by one warp in triple order, so the
//   result is the same from run to run.  Each product is rounded before
//   it is added (__fmul_rn, __fadd_rn, no fused multiply-add), which is the
//   arithmetic of the plain PyTorch version, U[c] * V[d] summed in order.
// Rows of U and V used by many triples are re-read from L2; keeping them
// in shared memory is left to a later, faster version.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.  The launch
// goes on the caller's stream, allocates nothing and does not synchronise.

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

// T is float4 (width = D / 4 vectors a row) or float (width = D).
template <typename T>
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

}  // namespace

// U: (u_rows, D) f32, V: (v_rows, D) f32, c and d: int32[k] in output-row
// order, rowptr: int32[out_rows + 1] with rowptr[0] == 0 and
// rowptr[out_rows] == k, out: (out_rows, D) f32.  Every index must be in
// range: the caller checks them on the host.  Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int spspmm_sum_fwd_f32(const float* U, const float* V,
                                  const int* c, const int* d,
                                  const int* rowptr, float* out,
                                  int64_t out_rows, int64_t D,
                                  void* stream) {
  if (out_rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (out_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  if (D % 4 == 0 && aligned16(U) && aligned16(V) && aligned16(out)) {
    spspmm_sum_kernel<float4><<<grid, block, 0, s>>>(
        reinterpret_cast<const float4*>(U), reinterpret_cast<const float4*>(V),
        c, d, rowptr, reinterpret_cast<float4*>(out), out_rows, D / 4);
  } else {
    spspmm_sum_kernel<float><<<grid, block, 0, s>>>(U, V, c, d, rowptr, out,
                                                    out_rows, D);
  }
  return (int)cudaGetLastError();
}
