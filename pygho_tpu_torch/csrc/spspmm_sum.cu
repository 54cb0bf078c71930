// K1: the sum contraction of sparse message passing, in its three roles,
//
//     forward:  out[a, :] += U[c, :] * V[d, :]   over triples (a, c, d)
//     dX:       dU[c, :]  += g[a, :] * V[d, :]   over triples (c, a, d)
//     dA:       dV[d, :]  += U[c, :] * g[a, :]   over triples (d, c, a)
//
// Each role is one kernel over triples (t, u, v) sorted by the output row
// t: out[t, :] += L[u, :] * R[v, :], with the triples given as three index
// arrays t, u, v in that order and a CSR row pointer over the output rows
// (rowptr).  The host builds each role's order (hodata/loader.py
// add_rowptr), so no role needs atomics.
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
// one of R (2 * D * 4 bytes) plus 12 bytes of indices and does 2 * D
// floating-point operations, about 0.25 operations a byte, far below the
// roughly 20 operations a byte at which f32 arithmetic would start to
// limit it.  The least traffic is every referenced row of L and R read
// once, the indices read once and every output row written once.  On the
// main path's batch (60,224 triples, D = 128) that is about 11 us, little
// more than a launch, and the rows are short: two triples on average in
// the forward and dX orders, eleven in the dA order.
//
// The design (chunk_walk.cuh): a warp takes a chunk of C triples of
// the role (the wrapper passes C, 32 at most) and sums the rows that
// start in it, kInFlight triples' gathers in registers before their adds;
// other warps store the zeros of the empty rows.  A first version gave
// each output row a warp, which waited out its row pointer, its index
// load and its gathers for two triples and left: 40-44% of the bound.
// With C = 32 and F = 8, the best of a sweep (scripts/k1_k4_ab_gpu.py),
// a role takes 6-16% less device time, 49-62% of the bound; with every
// gather on one row it still takes about half of that time: the stores
// (16.8 MB in the forward and dX roles) and the launch, not the gathers,
// are most of what is left.
// Each product is rounded before it is added (__fmul_rn, __fadd_rn, no
// fused multiply-add) and each row is summed from 0 in triple order by one
// warp, which is the arithmetic of the plain PyTorch version, L[u] * R[v]
// summed in order: every role equals it bit for bit, from run to run.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_walk.cuh"

namespace {

using chunk_walk::Vec;

constexpr int kWarpsPerBlock = 4;
// triples whose gathers a warp issues at once, in every role (the sweep
// of scripts/k1_k4_ab_gpu.py: 4 and 16 are slower)
constexpr int kInFlight = 8;

enum Role { kForward, kDX, kDA };

// out[t] += L[u] * R[v], for chunk_walk::stream_walk
template <int N>
struct Contract {
  const float* __restrict__ U;
  const float* __restrict__ V;
  float* __restrict__ out;
  int64_t D;

  struct Own {};
  struct Gat {
    Vec<N> x, y;
  };
  using Acc = Vec<N>;

  __device__ static Own zero_own() { return {}; }
  __device__ static Gat zero_gat() {
    return {chunk_walk::filled<N>(0.f), chunk_walk::filled<N>(0.f)};
  }
  __device__ static Acc zero() { return chunk_walk::filled<N>(0.f); }
  __device__ Own own(int, int64_t) const { return {}; }
  __device__ Gat gather(int uj, int vj, int64_t col) const {
    return {chunk_walk::load<N>(U, (int64_t)uj * D + col),
            chunk_walk::load<N>(V, (int64_t)vj * D + col)};
  }
  __device__ void add(Acc& acc, const Own&, const Gat& g) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc.x[i] = __fadd_rn(acc.x[i], __fmul_rn(g.x.x[i], g.y.x[i]));
  }
  __device__ void store(int row, int64_t col, const Acc& acc) const {
    chunk_walk::store<N>(out, (int64_t)row * D + col, acc);
  }
};

// Warps [0, n_chunks) take the chunks of `chunk` triples, warps
// [n_chunks, n_warps) store the zeros of the empty rows.  N floats a lane;
// the role only names the instance.
template <int N, Role role>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spspmm_sum_kernel(const float* __restrict__ U, const float* __restrict__ V,
                  const int* __restrict__ t, const int* __restrict__ u,
                  const int* __restrict__ v, const int* __restrict__ rowptr,
                  float* __restrict__ out, int k, int chunk,
                  int64_t n_chunks, int64_t n_warps, int64_t out_rows,
                  int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;  // whole warp leaves together
  if (w >= n_chunks) {
    float* const outs[1] = {out};
    chunk_walk::zero_rows<N, 1>(outs, rowptr, out_rows, w - n_chunks, lane,
                                D);
    return;
  }
  chunk_walk::Chunk ch;
  if (!chunk_walk::load_chunk(w, chunk, k, t, u, v, rowptr, lane, ch))
    return;
  const Contract<N> op{U, V, out, D};
  const int64_t width = D / N;  // lanes' worth of a row
  for (int64_t base = 0; base < width; base += 32) {
    const bool active = base + lane < width;  // all lanes join the shuffles
    chunk_walk::stream_walk<kInFlight>(op, ch, u, v, lane, active,
                                       (base + lane) * N);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <Role role>
int launch(const float* U, const float* V, const int* t, const int* u,
           const int* v, const int* rowptr, float* out, int64_t k,
           int64_t chunk, int64_t out_rows, int64_t D, void* stream) {
  if (out_rows <= 0 || D <= 0 || k < 0 || k >= 0x7fffffffLL - 32 ||
      chunk < 1 || chunk > 32)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (k + chunk - 1) / chunk;
  const int64_t n_warps =
      n_chunks + (out_rows + chunk_walk::kZeroRows - 1) /
                     chunk_walk::kZeroRows;
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  if (D % 4 == 0 && aligned16(U) && aligned16(V) && aligned16(out)) {
    spspmm_sum_kernel<4, role><<<grid, block, 0, s>>>(
        U, V, t, u, v, rowptr, out, (int)k, (int)chunk, n_chunks, n_warps,
        out_rows, D);
  } else {
    spspmm_sum_kernel<1, role><<<grid, block, 0, s>>>(
        U, V, t, u, v, rowptr, out, (int)k, (int)chunk, n_chunks, n_warps,
        out_rows, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: U: (u_rows, D) f32 and V: (v_rows, D) f32 (the
// role's L and R), t, u, v: int32[k], the role's triples sorted by t (u
// and v row indices into U and V), rowptr: int32[out_rows + 1], the row
// pointer of t (rowptr[0] == 0, rowptr[out_rows] == k), chunk: the
// triples of a warp's chunk (1 to 32), out: (out_rows, D) f32, written in
// full.  Every index must be in range: the caller checks them on the
// host.  Returns the cudaGetLastError() of the launch (0 on success).
#define SPSPMM_ENTRY(NAME, ROLE)                                            \
  extern "C" int NAME(const float* U, const float* V, const int* t,        \
                      const int* u, const int* v, const int* rowptr,       \
                      float* out, int64_t k, int64_t chunk,                \
                      int64_t out_rows, int64_t D, void* stream) {         \
    return launch<ROLE>(U, V, t, u, v, rowptr, out, k, chunk, out_rows, D, \
                        stream);                                           \
  }

// forward: out[a] += X[c] * A[d] over (a, c, d); U = X, V = A
SPSPMM_ENTRY(spspmm_sum_fwd_f32, kForward)
// dX: dX[c] += g[a] * A[d] over (c, a, d); U = g, V = A
SPSPMM_ENTRY(spspmm_sum_dx_f32, kDX)
// dA: dA[d] += X[c] * g[a] over (d, c, a); U = X, V = g
SPSPMM_ENTRY(spspmm_sum_da_f32, kDA)
