// The short-row schedule that K1 (spspmm_sum.cu) and K4
// (segment_attention.cu) share: a warp a chunk of triples.
//
// Both kernels walk triples (t, u, v) sorted by the output row t, and on
// the main path most rows hold one to six triples (two on average in the
// forward and dX orders, eleven in the dA order).  A warp a row waits out
// a chain of dependent loads (row pointer, indices, gathers) for two
// triples and leaves; here a warp takes a chunk of C consecutive triples
// (C <= 32) and owns the rows whose first triple lies in it:
//
// - the warp reads t, u and v of 32 triples from its chunk's first, one
//   coalesced load each (a lane a triple), and finds the chunk's row
//   starts with one ballot: triple i starts a row where t[i] != t[i - 1].
//   A row longer than its chunk stays with the warp where it starts; its
//   end is found in the same 32 triples or, for a row that runs past
//   them, in the row pointer.  No plan is built on the host: the chunks
//   come from the output-row array the wrappers already pass;
// - rows with no triples are stored as zeros by separate warps, one for
//   each run of 32 output rows (kZeroRows), read from the row pointer, so
//   a run of empty rows, such as a batch's padded tail, spreads over many
//   warps and every row is written by exactly one warp: the caller
//   allocates the outputs with torch.empty.  Those warps come after the
//   chunk warps in the grid;
// - the feature dim lies across the lanes, N floats a lane (a float4
//   where D % 4 == 0 and every pointer is 16-byte aligned, else one);
// - stream_walk, for roles that sum one term a triple: the warp issues the
//   gathers of F triples into registers before their adds, so F triples'
//   rows are in flight where a warp a row had its row's two, and loads a
//   row's own operands once, with the gathers of the group in which the
//   row starts;
// - each row is summed by one warp, from 0, in triple order, and stored
//   once (__stcs, evict-first: the outputs are not read again here), so
//   there are no atomics and every role repeats its plain version's bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chunk_walk {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kZeroRows = 32;  // output rows of one zeroing warp

// N floats of one lane: a float4 (N = 4) or one float (N = 1)
template <int N>
struct Vec {
  float x[N];
};

template <int N>
__device__ __forceinline__ Vec<N> filled(float f) {
  Vec<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.x[i] = f;
  return r;
}

template <int N>
__device__ __forceinline__ Vec<N> load(const float* __restrict__ p,
                                       int64_t off) {
  Vec<N> r;
  if constexpr (N == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + off));
    r.x[0] = q.x;
    r.x[1] = q.y;
    r.x[2] = q.z;
    r.x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.x[i] = __ldg(p + off + i);
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store(float* __restrict__ p, int64_t off,
                                      const Vec<N>& r) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<float4*>(p + off),
           make_float4(r.x[0], r.x[1], r.x[2], r.x[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) __stcs(p + off + i, r.x[i]);
  }
}

// One warp's chunk, the same on every lane but for t, u and v.
struct Chunk {
  int c0;           // the chunk's first triple
  int first;        // the first triple of the chunk's first row
  int end;          // one past the last triple of the chunk's last row
  unsigned starts;  // bit j: triple c0 + j starts a row (j < C)
  int t, u, v;      // triple c0 + lane (-1, 0, 0 past the k triples)
};

// Reads the chunk of warp w (w * C < k).  False where no row starts in it
// (the chunk lies inside a row that started before), and the warp is done.
__device__ __forceinline__ bool load_chunk(int64_t w, int C, int k,
                                           const int* __restrict__ t,
                                           const int* __restrict__ u,
                                           const int* __restrict__ v,
                                           const int* __restrict__ rowptr,
                                           int lane, Chunk& ch) {
  const int c0 = (int)(w * C);
  const int pos = c0 + lane;
  const bool in = pos < k;
  ch.t = in ? __ldg(t + pos) : -1;
  ch.u = in ? __ldg(u + pos) : 0;
  ch.v = in ? __ldg(v + pos) : 0;
  const int before = lane == 0 && c0 > 0 ? __ldg(t + c0 - 1) : -1;
  int prev = __shfl_up_sync(kFullMask, ch.t, 1);
  if (lane == 0) prev = before;
  ch.starts = __ballot_sync(kFullMask, lane < C && in && ch.t != prev);
  if (ch.starts == 0) return false;
  ch.c0 = c0;
  ch.first = c0 + __ffs(ch.starts) - 1;
  const int t_last = __shfl_sync(kFullMask, ch.t, 31 - __clz(ch.starts));
  // the last row's triples among the 32: it ends there unless it fills
  // them to the last lane
  const unsigned same = __ballot_sync(kFullMask, in && ch.t == t_last);
  const int top = 31 - __clz(same);
  ch.end = top < 31 ? c0 + top + 1 : __ldg(rowptr + t_last + 1);
  return true;
}

// Zeros of every output on the empty rows among kZeroRows rows from
// zw * kZeroRows: the zeroing warp zw.
template <int N, int kOuts>
__device__ __forceinline__ void zero_rows(float* const (&outs)[kOuts],
                                          const int* __restrict__ rowptr,
                                          int64_t out_rows, int64_t zw,
                                          int lane, int64_t D) {
  const int64_t r0 = zw * kZeroRows;
  const int64_t r = r0 + lane;
  const bool in = lane < kZeroRows && r < out_rows;
  const int lo = in ? __ldg(rowptr + r) : 0;
  const int hi = in ? __ldg(rowptr + r + 1) : 0;
  unsigned empty = __ballot_sync(kFullMask, in && lo == hi);
  const int64_t width = D / N;
  while (empty) {
    const int64_t row = r0 + __ffs(empty) - 1;
    empty &= empty - 1;
    for (int64_t c = lane; c < width; c += 32) {
#pragma unroll
      for (int o = 0; o < kOuts; ++o)
        store<N>(outs[o], row * D + c * N, filled<N>(0.f));
    }
  }
}

// The chunk's rows, summed by a role Op that adds one term a triple:
//
//   Op::Own       the row's own operands (loaded once a row, at its t)
//   Op::Gat       a triple's gathered operands (at its u and v)
//   Op::Acc       a row's sums
//   op.own(t, col), op.gather(u, v, col), Op::zero(),
//   op.add(acc, own, gat), op.store(t, col, acc)
//
// col is this lane's first float in a row.  The triples go in groups of F
// (fewer at the end of the 32 triples in the lanes): the group's gathers,
// and the own operands of the rows that start in it, are issued before the
// first add.  Past the first 32 triples all belong to the last row, whose
// indices are read 32 at a time.  Every lane joins the shuffles; only
// active lanes (col inside the row) load, add and store.
template <int F, typename Op>
__device__ __forceinline__ void stream_walk(const Op& op, const Chunk& ch,
                                            const int* __restrict__ u,
                                            const int* __restrict__ v,
                                            int lane, bool active,
                                            int64_t col) {
  int wb = ch.c0;  // the triple in lane 0
  int my_u = ch.u, my_v = ch.v;
  unsigned starts = ch.starts;
  int p = ch.first;
  int row = -1;
  typename Op::Own cur = Op::zero_own();
  typename Op::Acc acc = Op::zero();
  while (p < ch.end) {
    if (p == wb + 32) {  // the last row runs on: its next 32 triples
      wb = p;
      starts = 0;
      const int pos = wb + lane;
      my_u = pos < ch.end ? __ldg(u + pos) : 0;
      my_v = pos < ch.end ? __ldg(v + pos) : 0;
    }
    const int rel = p - wb;
    const int n = min(min(F, ch.end - p), 32 - rel);
    typename Op::Gat g[F];
    typename Op::Own o[F];
    int tq[F];
#pragma unroll
    for (int q = 0; q < F; ++q) {
      const int j = min(rel + q, 31);
      const int uj = __shfl_sync(kFullMask, my_u, j);
      const int vj = __shfl_sync(kFullMask, my_v, j);
      tq[q] = __shfl_sync(kFullMask, ch.t, j);
      g[q] = Op::zero_gat();
      o[q] = Op::zero_own();
      if (active && q < n) {
        g[q] = op.gather(uj, vj, col);
        if ((starts >> j) & 1u) o[q] = op.own(tq[q], col);
      }
    }
#pragma unroll
    for (int q = 0; q < F; ++q) {
      if (q >= n) break;
      if ((starts >> (rel + q)) & 1u) {  // triple q starts a row
        if (row >= 0 && active) op.store(row, col, acc);
        acc = Op::zero();
        row = tq[q];
        cur = o[q];
      }
      if (active) op.add(acc, cur, g[q]);
    }
    p += n;
  }
  if (active) op.store(row, col, acc);
}

}  // namespace chunk_walk
