// K3: K1's sum contraction on a window schedule, in its three roles,
//
//     forward:  out[a, :] += X[c, :] * A[d, :]   over triples (a, c, d)
//     dX:       dX[c, :]  += g[a, :] * A[d, :]   over triples (c, a, d)
//     dA:       dA[d, :]  += X[c, :] * g[a, :]   over triples (d, c, a)
//
// each as out[t, :] += U[u, :] * V[v, :] over the role's triples (t, u, v),
// with V read from windows staged in shared memory.
//
// Replaces the TPU kernel pygho_tpu/kernels/strip_spspmm.py:689
// _strip_kernel_pv, the persistent-V-window variant of the strip kernel:
// its host plan (build_strip_plan(..., v_persistent=True), _build_v_sched)
// copies each V window, for example one community's edge block of a giant
// graph, into VMEM once and reuses it across all the grid steps that read
// it.  The TPU grid runs in order on one core, so a window persists across
// steps; Hopper's blocks run in parallel and share nothing, so here the
// unit that keeps a window is one block: the host (kernels/window_spspmm.py
// build_window_plan) cuts the output rows into groups of consecutive rows,
// gives each group an ordered list of V windows (base, rows), merged
// greedily by the union of their spans as the TPU planner merges them, and
// lists, for each window, the group's "pieces": one output row's triples
// that read that window, with v made window-local.
//
// What bounds it on an H100: memory, as K1.  Each triple reads a row of U
// and a row of V and does 2 operations a channel, far below the ~20
// operations a byte at which f32 arithmetic would limit it.  The least
// traffic is every referenced row of U and V read once, the indices once
// and every output row written once.  The windows read each V row once a
// group instead of once a triple; the U rows are gathered from device
// memory (through L2) per triple, as K1 gathers them.
//
// The design:
// - one block per (group, slice of 32 channels): grid (groups, ceil(D/32)).
//   A slice, not the whole width, because a window of one community's
//   ~950 edge rows at D = 128 in f32 is 486 KB, over the 227 KB of shared
//   memory a block can have; 32 channels make a 512-row window 64 KB, so
//   three blocks share an SM and one block's window load runs under the
//   others' sums.  The planner caps a window's rows (its `cap`), and the
//   wrapper refuses a plan whose largest window does not fit.  A slice of
//   32 channels is one f32 per lane, so any D works with one code path
//   (the last slice masks its lanes past D);
// - for each window of its group, in order: __syncthreads, the block copies
//   V[base : base + rows, slice] into dynamic shared memory with coalesced
//   loads (a warp reads one row's 128-byte slice), __syncthreads, then each
//   warp takes the window's pieces in turn, one output row a piece, as K1
//   takes rows: it loads 32 (u, v) pairs with one coalesced load each, hands
//   them to the lanes by shuffle, gathers U[u, slice] from device memory,
//   reads V from the window (lane i reads bank i: no conflicts), and keeps
//   the row's sum in a register;
// - a row whose triples read several windows has one piece in each, in
//   window order; its first piece stores its sum and each later piece adds
//   to what the earlier window stored (the __syncthreads before each window
//   makes those stores visible to every warp of the block).  Every output
//   row belongs to one group, so it is written by one block, with no
//   atomics; a row with no triples has an empty first piece and stores 0,
//   so the caller allocates the output with torch.empty;
// - the arithmetic is K1's: each product rounded, then added (__fmul_rn,
//   __fadd_rn, no fused multiply-add), in the triple order within a piece
//   and in window order across pieces, so a run gives the same bits every
//   time.  A row inside one window sums in K1's order and gives K1's bits;
//   a row split across windows may differ from them in the last bits.
// - more than 48 KB of dynamic shared memory needs the kernel's attribute
//   raised (cudaFuncSetAttribute) before the launch; a launch refused for
//   too much shared memory never runs and synchronising does not report it,
//   so each entry point returns cudaGetLastError() and the wrapper raises.
// Double-buffering the next window under the current one (the two VMEM
// slots of _build_v_sched) and TMA copies are left to a later version.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel, so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Role { kForward, kDX, kDA };

// The role only names the instance.  U and V are the role's operands (u
// rows and v rows of D floats); u and vloc its triples' indices in piece
// order, vloc relative to the piece's window.
template <Role role>
__global__ void __launch_bounds__(kThreads)
window_spspmm_kernel(const float* __restrict__ U, const float* __restrict__ V,
                     const int* __restrict__ u, const int* __restrict__ vloc,
                     const int* __restrict__ piece_ptr,
                     const int* __restrict__ piece_row,
                     const int* __restrict__ win_base,
                     const int* __restrict__ win_rows,
                     const int* __restrict__ win_piece,
                     const int* __restrict__ grp_win,
                     float* __restrict__ out, int64_t D) {
  extern __shared__ float window[];  // [rows][kSlice]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t slice0 = (int64_t)blockIdx.y * kSlice;
  const int64_t col = slice0 + lane;
  const bool active = col < D;  // inactive lanes still join the shuffles
  const int g = blockIdx.x;
  const int w1 = __ldg(grp_win + g + 1);
  for (int w = __ldg(grp_win + g); w < w1; ++w) {
    const int64_t base = __ldg(win_base + w);
    const int n_elem = __ldg(win_rows + w) * kSlice;
    __syncthreads();  // the previous window is no longer read
#pragma unroll 4
    for (int i = threadIdx.x; i < n_elem; i += kThreads) {
      const int64_t c = slice0 + (i & (kSlice - 1));
      window[i] = c < D ? __ldg(V + (base + i / kSlice) * D + c) : 0.f;
    }
    __syncthreads();  // the window is staged; earlier pieces' stores seen
    const int p1 = __ldg(win_piece + w + 1);
    for (int p = __ldg(win_piece + w) + warp; p < p1; p += kWarps) {
      int row = __ldg(piece_row + p);
      const bool add = row < 0;
      if (add) row = ~row;
      const int start = __ldg(piece_ptr + p);
      const int end = __ldg(piece_ptr + p + 1);
      float acc = 0.f;
      for (int t0 = start; t0 < end; t0 += 32) {
        const int n = min(32, end - t0);
        int my_u = 0, my_v = 0;
        if (lane < n) {
          my_u = __ldg(u + t0 + lane);
          my_v = __ldg(vloc + t0 + lane);
        }
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const int uj = __shfl_sync(kFullMask, my_u, j);
          const int vj = __shfl_sync(kFullMask, my_v, j);
          if (active) {
            const float x = __ldg(U + (int64_t)uj * D + col);
            acc = __fadd_rn(acc, __fmul_rn(x, window[vj * kSlice + lane]));
          }
        }
      }
      if (active) {
        float* o = out + (int64_t)row * D + col;
        *o = add ? __fadd_rn(*o, acc) : acc;
      }
    }
  }
}

template <Role role>
int launch(const float* U, const float* V, const int* u, const int* vloc,
           const int* piece_ptr, const int* piece_row, const int* win_base,
           const int* win_rows, const int* win_piece, const int* grp_win,
           float* out, int64_t n_groups, int64_t D, int64_t max_rows,
           void* stream) {
  if (n_groups <= 0 || D <= 0 || max_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t slices = (D + kSlice - 1) / kSlice;
  if (n_groups > 0x7fffffffLL || slices > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)max_rows * kSlice * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_spspmm_kernel<role>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_groups, (unsigned)slices);
  window_spspmm_kernel<role><<<grid, kThreads, smem, s>>>(
      U, V, u, vloc, piece_ptr, piece_row, win_base, win_rows, win_piece,
      grp_win, out, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: U (u_rows, D) and V (v_rows, D) f32, the role's
// operands; u, vloc: int32[k] in piece order; piece_ptr: int32[pieces + 1];
// piece_row: int32[pieces] (row, or ~row for a piece that adds);
// win_base, win_rows: int32[windows]; win_piece: int32[windows + 1];
// grp_win: int32[n_groups + 1]; out: (out_rows, D) f32; max_rows: the most
// rows of any window (the dynamic shared memory is max_rows * 32 floats).
// The plan is built and checked on the host (build_window_plan).  Returns
// the cudaGetLastError() of the launch (0 on success).
#define WINDOW_ENTRY(NAME, ROLE)                                              \
  extern "C" int NAME(const float* U, const float* V, const int* u,          \
                      const int* vloc, const int* piece_ptr,                 \
                      const int* piece_row, const int* win_base,             \
                      const int* win_rows, const int* win_piece,             \
                      const int* grp_win, float* out, int64_t n_groups,      \
                      int64_t D, int64_t max_rows, void* stream) {           \
    return launch<ROLE>(U, V, u, vloc, piece_ptr, piece_row, win_base,       \
                        win_rows, win_piece, grp_win, out, n_groups, D,      \
                        max_rows, stream);                                   \
  }

// forward: out[a] += X[c] * A[d] over (a, c, d); U = X, V = A
WINDOW_ENTRY(window_spspmm_fwd_f32, kForward)
// dX: dX[c] += g[a] * A[d] over (c, a, d); U = g, V = A
WINDOW_ENTRY(window_spspmm_dx_f32, kDX)
// dA: dA[d] += X[c] * g[a] over (d, c, a); U = X, V = g
WINDOW_ENTRY(window_spspmm_da_f32, kDA)
