// K3: K1's sum contraction as a short-row gather, in its three roles,
//
//     forward:  out[a, :] += X[c, :] * A[d, :]   over triples (a, c, d)
//     dX:       dX[c, :]  += g[a, :] * A[d, :]   over triples (c, a, d)
//     dA:       dA[d, :]  += X[c, :] * g[a, :]   over triples (d, c, a)
//
// each as out[t, :] += U[u, :] * V[v, :] over the role's triples (t, u, v),
// sorted by the output row t, with a CSR row pointer over the output rows:
// the orders K1 reads (hodata/loader.py backward_orders, row_pointer).
//
// Replaces the TPU kernel pygho_tpu/kernels/strip_spspmm.py:689
// _strip_kernel_pv, the persistent-V-window variant of the strip kernel:
// its host plan copies each V window (one community's edge block of a giant
// graph) into VMEM once and reuses it across the grid steps that read it,
// because a TPU core gathers rows only through one-hot matrix products over
// what VMEM holds.  A Hopper warp gathers rows by index, and the 50 MB L2
// gives the reuse the windows bought: on the giant graph the RCM order
// interleaves communities, so a window schedule staged about 1.0 M V rows
// for 190,661 distinct ones, and a first version of this kernel that staged
// windows in shared memory ran at 18-22% of its bound while K1, with no
// windows, ran at 73% on the same triples.  So this version stages no
// window: it is K1's gather, scheduled for short rows.
//
// What bounds it on an H100: memory.  Each triple reads a row of U and a
// row of V (2 * D * 4 bytes) and 8 bytes of indices and does 2 * D
// operations, far below the ~20 operations a byte at which f32 arithmetic
// would limit it.  The least traffic is every referenced row of U and V
// read once, the indices once and every output row written once.  Rows of
// the giant graph hold about 2.4 triples, so a warp a row (K1) waits out
// its dependent loads (row pointer, indices, gathers) for two or three
// triples at a time; a warp a chunk waits for them once per 32.  Measured
// at the giant shape (scripts/k3_gather_ab_gpu.py), this kernel runs at
// 74-75% of the bound, level with K1 or slightly ahead: every triple
// still gathers two whole rows through L2, 2.8 times the rows the bound
// counts, from 205 MB of distinct rows, four times the L2.
//
// The design:
// - a warp takes a *chunk* of output rows: the host (kernels/
//   window_spspmm.py build_chunk_plan) gives warp w the rows whose first
//   triple lies in one run of 32 triples, at most 32 rows (so a run of
//   empty rows, the padded tail, spreads over many warps).  Each row is
//   owned by one warp, so there are no atomics and no second pass; a row
//   with no triples is stored as zeros by its owner, so the caller
//   allocates the output with torch.empty;
// - the warp loads its rows' ends with one coalesced load (a lane a row)
//   and its triples' (u, v) pairs 32 at a time with one coalesced load
//   each (a chunk's pairs, and the tail of its last row where that runs
//   past the chunk), and hands them to the lanes by shuffle;
// - the feature dim across the lanes, 16 bytes a lane (float4), so all 128
//   channels of a row are one coalesced 512-byte gather; a scalar path
//   takes D % 4 != 0 or pointers not 16-byte aligned;
// - the gathers of kInFlight triples (2 * kInFlight rows) are issued into
//   registers before their adds, so a warp keeps that many in flight where
//   a warp a row (K1) has its row's 2.4.  Eight is the measured best: 4 or
//   16 (fewer warps fit an SM) take 8-18% longer, and a per-warp ring of
//   cp.async copies in shared memory in place of the registers 1-3%
//   longer;
// - the rows are walked in order and each row's sum stays in registers and
//   is stored when the row ends, with the evict-first hint (__stcs): the
//   output is written once and never read here, so it should not push
//   gathered rows out of L2 (about 1% faster than a plain store);
// - the arithmetic is K1's: the triples in their given order, each product
//   rounded before it is added (__fmul_rn, __fadd_rn, no fused
//   multiply-add), so every role equals its plain version, and K1, bit for
//   bit, and a run gives the same bits every time.
//
// Variants (the JAX kernel's _strip_math, strip_spspmm.py:653-686): every
// role is one template over the math mode, with the same walk and the same
// f32 sums in the same order.  f32: as above.  f32 fast (exact=False, the
// giant graph's --fast runs): U[u] and V[v] are rounded to bf16, their
// product is formed in f32 (exact for two bf16 values) and rounded to bf16
// once more before it is added; in dX and dA the cotangent g is one of the
// operands, so it is rounded too, as _bwd_rule passes exact to both.  The
// roundings are K1's (chunk_walk::round_bf16, round-to-nearest-even, as
// Tensor.to(torch.bfloat16)), so each fast role equals its plain version
// and K1's f32fast role bit for bit.  They are made in the loop of adds,
// after every gather of the group is issued, where K1 found that they
// cost nothing; the bytes moved are the f32 variant's.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel, so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_walk.cuh"

namespace {

using chunk_walk::round_bf16;
using chunk_walk::term;

constexpr int kWarpsPerBlock = 8;
constexpr int kInFlight = 8;   // triples whose gathers a warp issues at once
constexpr unsigned kFullMask = 0xffffffffu;

// acc + u * v, in fast mode with u, v and their product rounded to bf16
template <bool FAST>
__device__ __forceinline__ float mul_add(float acc, float u, float v) {
  if constexpr (FAST) {
    u = round_bf16(u);
    v = round_bf16(v);
  }
  return __fadd_rn(acc, term<FAST>(__fmul_rn(u, v)));
}

template <bool FAST>
__device__ __forceinline__ float4 mul_add(float4 acc, float4 u, float4 v) {
  acc.x = mul_add<FAST>(acc.x, u.x, v.x);
  acc.y = mul_add<FAST>(acc.y, u.y, v.y);
  acc.z = mul_add<FAST>(acc.z, u.z, v.z);
  acc.w = mul_add<FAST>(acc.w, u.w, v.w);
  return acc;
}

__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }

enum Role { kForward, kDX, kDA };

// T is float4 (width = D / 4 vectors a row) or float (width = D); the role
// only names the instance, FAST is the math mode.  U and V are the role's operands, u and v its
// triples' indices in output-row order, rowptr the row pointer of their
// output rows and warp_row[w] : warp_row[w + 1] the rows of warp w (1 to 32).
template <typename T, Role role, bool FAST>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_spspmm_kernel(const T* __restrict__ U, const T* __restrict__ V,
                     const int* __restrict__ u, const int* __restrict__ v,
                     const int* __restrict__ rowptr,
                     const int* __restrict__ warp_row,
                     T* __restrict__ out, int64_t n_warps, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;  // whole warp leaves together
  const int r0 = __ldg(warp_row + w);
  const int rows = __ldg(warp_row + w + 1) - r0;
  // lane l holds the end of the warp's row l
  const int my_end = lane < rows ? __ldg(rowptr + r0 + 1 + lane) : 0;
  const int t0 = __ldg(rowptr + r0);
  const int t1 = __shfl_sync(kFullMask, my_end, rows - 1);
  for (int64_t base = 0; base < width; base += 32) {
    const int64_t col = base + lane;
    const bool active = col < width;  // every lane still joins the shuffles
    T* o = out + (int64_t)r0 * width + col;
    int ri = 0;                                  // the row being summed
    int end = __shfl_sync(kFullMask, my_end, 0);  // and its end
    T acc = zero_of(T());
    for (int c0 = t0; c0 < t1; c0 += 32) {
      const int n = min(32, t1 - c0);
      int my_u = 0, my_v = 0;
      if (lane < n) {
        my_u = __ldg(u + c0 + lane);
        my_v = __ldg(v + c0 + lane);
      }
      for (int j0 = 0; j0 < n; j0 += kInFlight) {
        T xu[kInFlight], xv[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int j = min(j0 + q, n - 1);
          const int uj = __shfl_sync(kFullMask, my_u, j);
          const int vj = __shfl_sync(kFullMask, my_v, j);
          xu[q] = zero_of(T());
          xv[q] = zero_of(T());
          if (active && j0 + q < n) {
            xu[q] = __ldg(U + (int64_t)uj * width + col);
            xv[q] = __ldg(V + (int64_t)vj * width + col);
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (j0 + q >= n) break;
          const int t = c0 + j0 + q;
          while (t >= end) {  // triple t starts a later row: store this one
            if (active) __stcs(o + (int64_t)ri * width, acc);
            acc = zero_of(T());
            ++ri;
            end = __shfl_sync(kFullMask, my_end, ri);
          }
          if (active) acc = mul_add<FAST>(acc, xu[q], xv[q]);
        }
      }
    }
    // the last row with triples, then any empty rows after it
    for (; ri < rows; ++ri) {
      if (active) __stcs(o + (int64_t)ri * width, acc);
      acc = zero_of(T());
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <Role role, bool FAST>
int launch(const float* U, const float* V, const int* u, const int* v,
           const int* rowptr, const int* warp_row, float* out,
           int64_t n_warps, int64_t D, void* stream) {
  if (n_warps <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  if (D % 4 == 0 && aligned16(U) && aligned16(V) && aligned16(out)) {
    window_spspmm_kernel<float4, role, FAST><<<grid, block, 0, s>>>(
        reinterpret_cast<const float4*>(U), reinterpret_cast<const float4*>(V),
        u, v, rowptr, warp_row, reinterpret_cast<float4*>(out), n_warps,
        D / 4);
  } else {
    window_spspmm_kernel<float, role, FAST><<<grid, block, 0, s>>>(
        U, V, u, v, rowptr, warp_row, out, n_warps, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: U (u_rows, D) and V (v_rows, D) f32, the role's
// operands; u, v: int32[k], the triples' indices into U and V in output-row
// order; rowptr: int32[out_rows + 1]; warp_row: int32[n_warps + 1], the
// first row of each warp's chunk (warp_row[n_warps] == out_rows, 1 to 32
// rows a warp); out: (out_rows, D) f32, written in full.  The plan is built
// and checked on the host (build_chunk_plan).  Returns the
// cudaGetLastError() of the launch (0 on success).
#define WINDOW_ENTRY(NAME, ROLE, FAST)                                       \
  extern "C" int NAME(const float* U, const float* V, const int* u,         \
                      const int* v, const int* rowptr, const int* warp_row, \
                      float* out, int64_t n_warps, int64_t D,               \
                      void* stream) {                                       \
    return launch<ROLE, FAST>(U, V, u, v, rowptr, warp_row, out, n_warps,   \
                              D, stream);                                   \
  }

// forward: out[a] += X[c] * A[d] over (a, c, d); U = X, V = A
WINDOW_ENTRY(window_spspmm_fwd_f32, kForward, false)
// dX: dX[c] += g[a] * A[d] over (c, a, d); U = g, V = A
WINDOW_ENTRY(window_spspmm_dx_f32, kDX, false)
// dA: dA[d] += X[c] * g[a] over (d, c, a); U = X, V = g
WINDOW_ENTRY(window_spspmm_da_f32, kDA, false)

// the same roles in fast mode (every operand rounded to bf16 as it is
// used, each product once more)
WINDOW_ENTRY(window_spspmm_fwd_f32fast, kForward, true)
WINDOW_ENTRY(window_spspmm_dx_f32fast, kDX, true)
WINDOW_ENTRY(window_spspmm_da_f32fast, kDA, true)
