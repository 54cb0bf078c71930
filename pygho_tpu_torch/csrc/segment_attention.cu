// K4: the softmax-attention aggregate of NGAT and its three gradient
// roles.  Over triples (a, c, d), per channel,
//
//     s = (a1[c] * aA[d]) * a2[a]        M[a] = max of s over the row of a
//     e = exp(s - M[a])                  den[a] = sum e
//     out[a] = sum e * a3[c] / den[a]    (out, den and M are 0 on a row
//                                         with no triples)
//
// and, with gZ = g / den, goZ = gZ * out, ds = e * (a3[c] * gZ[a] - goZ[a])
// (gZ and goZ computed by the caller):
//
//     forward: out, den, M                     over (a, c, d) by a
//     dw:      d_a2[a] += (ds * a1[c]) * aA[d]  over (a, c, d) by a
//     dc:      d_a1[c] += (ds * aA[d]) * a2[a],
//              d_a3[c] += e * gZ[a]             over (c, a, d) by c
//     dv:      d_aA[d] += (ds * a1[c]) * a2[a]  over (d, c, a) by d
//
// Each role is one kernel over the role's triples (t, u, v) sorted by its
// output row t, given as three index arrays in that order and a CSR row
// pointer over the output rows (rowptr).  The host builds each
// role's order (hodata/loader.py add_rowptr, the same orders as K1's
// roles), so no role needs atomics.
//
// Replaces the four roles of the TPU kernel
// pygho_tpu/kernels/strip_attention.py:_att_kernel (launched by
// strip_attention_role, behind fused_attention_strip).  That kernel
// gathered rows with one-hot matrix products over windows and strips, and
// shifted each row by a bound, |a2[a]| * max|a1| * max|aA|, because one
// pass over one-hot windows cannot take a row's maximum; where the bound
// overshot the row's true maximum by more than about 60 nats, its
// denominator fell under a floor and the row came out 0.  A Hopper SM
// gathers rows by index and walks a row's triples as often as it likes,
// so this kernel takes the exact per-row, per-channel maximum first and
// needs no floor: den >= 1 on every row with triples.
//
// What bounds it on an H100: memory.  Each triple of the forward reads three
// rows (a1[c], aA[d], a3[c]); a gradient role reads three to six rows a
// triple (dv: a1, a3, a2, M, gZ, goZ).  Per element that is a handful of
// multiplications and one exp, under one operation a byte, far below the
// roughly 20 operations a byte at which f32 arithmetic would limit it.
// The least traffic is every referenced row of every operand read once,
// the indices read once and every output written once.
//
// The design (chunk_walk.cuh, shared with K1): a warp takes a chunk of C
// triples of the role (the wrapper passes C, 32 at most) and owns
// the rows that start in it; other warps store the zeros of the empty rows
// (out, den and M of the forward are 0 there).  The rows are short: two
// triples on average in the forward and dc orders of the main path, eleven
// in the dv order.
// - dw, dc and dv sum one term a triple (chunk_walk::stream_walk): the
//   gathers of kInFlight triples (three, five and six rows a triple) are
//   issued together before their adds, and a row's own operands (a2, M, gZ,
//   goZ in dw; a1, a3 in dc; aA in dv) are loaded once, with the gathers of
//   the group in which the row starts;
// - the forward takes whole rows, as many as fit in kInFlightFwd triples,
//   and gathers a1[c], aA[d], a3[c] of all their triples and each row's
//   a2 at once; the exact per-row maximum, then e, num and den, come from
//   those registers, so each gathered row is read once.  A row longer than
//   kInFlightFwd triples (rare: the main path's longest forward row holds
//   eleven) is walked twice, kInFlightFwd triples' gathers at a time, and
//   its rows are read again, from L2, in the second pass;
// - no atomics: each row is summed by one warp in triple order, so the
//   result is the same from run to run.  Every product, difference, sum
//   and the final division are rounded on their own (__fmul_rn, __fsub_rn,
//   __fadd_rn, __fdiv_rn: no fused multiply-add), in the order written
//   above, and exp is the accurate expf (no fast math), which is the
//   arithmetic of the plain PyTorch version: every role equals it bit for
//   bit.  The maximum is the exact one of two passes, not an online one,
//   which would rescale the sums and change their bits.
// A first version gave each output row a warp, walked the forward's rows
// twice and had one triple's gathers in flight: 44-66% of the bound.  This
// one takes 2-6% less device time (scripts/k1_k4_ab_gpu.py), 59-74% of
// the bound; with every gather on one row a role still takes 45-83% of its
// time, so the latency of its arithmetic at the occupancy its registers
// allow (96 to 240 a thread), and the forward's three outputs, set it more
// than the gathers do.
//
// Variants (the JAX kernel's _att_math, strip_attention.py:83-158): every
// role is one template over the stored type of a1, a3, aA and a2 (f32 or
// bf16; M, gZ, goZ and every output stay f32) and the math mode, with the
// same walk, the same maximum and the same f32 sums in the same order.  In
// fast mode (exact=False) every operand a role reads but M (a1, a3, aA,
// a2, gZ, goZ) is rounded to bf16 as it is loaded, e and the messages are
// formed in f32, and each message (the forward's e * a3 and e, each
// gradient's term) is rounded to bf16 once more before it is added.  The
// shift stays the exact per-row maximum in both modes: the JAX kernel's
// |a2| * max|a1| * max|aA| differs from it by a constant of the row, which
// cancels in the ratio.  The roundings are round-to-nearest-even, as the
// plain version's, so every variant equals its plain version bit for bit.
// A bf16 variant reads a1, a3, aA and a2 at half the bytes.  Rows are
// loaded as stored and widened (and rounded) only once a group's loads
// are all issued: widening each as it arrived held the next load back and
// cost the first version up to 62% of the f32 roles' time.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chunk_walk.cuh"

namespace {

using chunk_walk::filled;
using chunk_walk::kFullMask;
using chunk_walk::load_raw;
using chunk_walk::Raw;
using chunk_walk::store;
using chunk_walk::term;
using chunk_walk::Vec;
using chunk_walk::widen;
using chunk_walk::zero_raw;

constexpr int kWarpsPerBlock = 4;
// triples whose gathers a warp issues at once, per role (the sweep of
// scripts/k1_k4_ab_gpu.py: 4 for the forward sends its rows of five to
// eight triples down the two-pass path; 8 for dw spills)
constexpr int kInFlightFwd = 8;
constexpr int kInFlightDW = 4;
constexpr int kInFlightDC = 2;
constexpr int kInFlightDV = 2;

enum Role { kForward, kDW, kDC, kDV };

template <Role role>
__host__ __device__ constexpr int in_flight() {
  return role == kForward ? kInFlightFwd
         : role == kDW    ? kInFlightDW
         : role == kDC    ? kInFlightDC
                          : kInFlightDV;
}

// the operands a1, a3, aA, a2 stored as T; FAST: the math mode
template <typename T, bool FAST>
struct Params {
  const T* a1;
  const T* a3;
  const T* aA;
  const T* a2;
  const float* M;    // gradient roles only
  const float* gZ;   // gradient roles only
  const float* goZ;  // gradient roles only
  const int* t;      // the role's output row of each triple
  const int* u;      // the role's second index of each triple
  const int* v;      // the role's third index of each triple
  const int* rowptr;
  float* out0;  // forward: out; dw: d_a2; dc: d_a1; dv: d_aA
  float* out1;  // forward: den; dc: d_a3
  float* out2;  // forward: M
  int k;        // triples
  int chunk;    // triples of a warp's chunk
  int64_t n_chunks;
  int64_t n_warps;
  int64_t out_rows;
  int64_t D;
};

// s = (a1 * aA) * a2, each product rounded
__device__ __forceinline__ float score(float x1, float av, float w) {
  return __fmul_rn(__fmul_rn(x1, av), w);
}

// e = exp(s - M), the difference rounded, exp the accurate expf
__device__ __forceinline__ float expo(float x1, float av, float w,
                                      float m) {
  return expf(__fsub_rn(score(x1, av, w), m));
}

// ds = e * (a3 * gZ - goZ), each step rounded
__device__ __forceinline__ float dscore(float e, float x3, float gz,
                                        float goz) {
  return __fmul_rn(e, __fsub_rn(__fmul_rn(x3, gz), goz));
}

// acc += (p * q) * r, each step rounded, the term rounded to bf16 in fast
// mode
template <bool FAST>
__device__ __forceinline__ float add3(float acc, float p, float q, float r) {
  return __fadd_rn(acc, term<FAST>(__fmul_rn(__fmul_rn(p, q), r)));
}

template <int N>
struct V4 {  // a2, M, gZ, goZ of one row, as the math reads them
  Vec<N> w, m, gz, goz;
};

template <int N, typename T>
struct R4 {  // a2, M, gZ, goZ of one row, as they are stored
  Raw<N, T> w;
  Raw<N, float> m, gz, goz;
};

template <int N, typename T, bool FAST>
__device__ __forceinline__ R4<N, T> load4(const Params<T, FAST>& p,
                                          int64_t at) {
  return {load_raw<N>(p.a2, at), load_raw<N>(p.M, at),
          load_raw<N>(p.gZ, at), load_raw<N>(p.goZ, at)};
}

template <int N, typename T>
__device__ __forceinline__ R4<N, T> zero4() {
  return {zero_raw<N, T>(), zero_raw<N, float>(), zero_raw<N, float>(),
          zero_raw<N, float>()};
}

// M as it is, a2, gZ and goZ rounded in fast mode
template <int N, bool FAST, typename T>
__device__ __forceinline__ V4<N> widen4(const R4<N, T>& r) {
  return {widen<N, FAST>(r.w), widen<N, false>(r.m), widen<N, FAST>(r.gz),
          widen<N, FAST>(r.goz)};
}

// The gradient roles, as chunk_walk::stream_walk ops.  Own and Gat hold
// the rows as they are stored; add widens them.

// dw over (a, c, d): d_a2[a] += (ds * a1[c]) * aA[d]; own a2, M, gZ, goZ
template <int N, typename T, bool FAST>
struct DwOp {
  const Params<T, FAST>& p;
  using Own = R4<N, T>;
  struct Gat {
    Raw<N, T> x1, x3, av;
  };
  using Acc = Vec<N>;
  __device__ static Own zero_own() { return zero4<N, T>(); }
  __device__ static Gat zero_gat() {
    return {zero_raw<N, T>(), zero_raw<N, T>(), zero_raw<N, T>()};
  }
  __device__ static Acc zero() { return filled<N>(0.f); }
  __device__ Own own(int a, int64_t col) const {
    return load4<N>(p, (int64_t)a * p.D + col);
  }
  __device__ Gat gather(int c, int d, int64_t col) const {
    const int64_t at = (int64_t)c * p.D + col;
    return {load_raw<N>(p.a1, at), load_raw<N>(p.a3, at),
            load_raw<N>(p.aA, (int64_t)d * p.D + col)};
  }
  __device__ void add(Acc& acc, const Own& own, const Gat& gat) const {
    const V4<N> o = widen4<N, FAST>(own);
    const Vec<N> x1 = widen<N, FAST>(gat.x1), x3 = widen<N, FAST>(gat.x3),
                 av = widen<N, FAST>(gat.av);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = expo(x1.x[i], av.x[i], o.w.x[i], o.m.x[i]);
      const float ds = dscore(e, x3.x[i], o.gz.x[i], o.goz.x[i]);
      acc.x[i] = add3<FAST>(acc.x[i], ds, x1.x[i], av.x[i]);
    }
  }
  __device__ void store(int a, int64_t col, const Acc& acc) const {
    chunk_walk::store<N>(p.out0, (int64_t)a * p.D + col, acc);
  }
};

// dc over (c, a, d): d_a1[c] += (ds * aA[d]) * a2[a], d_a3[c] += e * gZ[a];
// own a1, a3
template <int N, typename T, bool FAST>
struct DcOp {
  const Params<T, FAST>& p;
  struct Own {
    Raw<N, T> x1, x3;
  };
  struct Gat {
    R4<N, T> r;
    Raw<N, T> av;
  };
  struct Acc {
    Vec<N> d1, d3;
  };
  __device__ static Own zero_own() {
    return {zero_raw<N, T>(), zero_raw<N, T>()};
  }
  __device__ static Gat zero_gat() {
    return {zero4<N, T>(), zero_raw<N, T>()};
  }
  __device__ static Acc zero() { return {filled<N>(0.f), filled<N>(0.f)}; }
  __device__ Own own(int c, int64_t col) const {
    const int64_t at = (int64_t)c * p.D + col;
    return {load_raw<N>(p.a1, at), load_raw<N>(p.a3, at)};
  }
  __device__ Gat gather(int a, int d, int64_t col) const {
    return {load4<N>(p, (int64_t)a * p.D + col),
            load_raw<N>(p.aA, (int64_t)d * p.D + col)};
  }
  __device__ void add(Acc& acc, const Own& own, const Gat& gat) const {
    const Vec<N> x1 = widen<N, FAST>(own.x1), x3 = widen<N, FAST>(own.x3),
                 av = widen<N, FAST>(gat.av);
    const V4<N> r = widen4<N, FAST>(gat.r);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = expo(x1.x[i], av.x[i], r.w.x[i], r.m.x[i]);
      const float ds = dscore(e, x3.x[i], r.gz.x[i], r.goz.x[i]);
      acc.d1.x[i] = add3<FAST>(acc.d1.x[i], ds, av.x[i], r.w.x[i]);
      acc.d3.x[i] =
          __fadd_rn(acc.d3.x[i], term<FAST>(__fmul_rn(e, r.gz.x[i])));
    }
  }
  __device__ void store(int c, int64_t col, const Acc& acc) const {
    const int64_t at = (int64_t)c * p.D + col;
    chunk_walk::store<N>(p.out0, at, acc.d1);
    chunk_walk::store<N>(p.out1, at, acc.d3);
  }
};

// dv over (d, c, a): d_aA[d] += (ds * a1[c]) * a2[a]; own aA
template <int N, typename T, bool FAST>
struct DvOp {
  const Params<T, FAST>& p;
  using Own = Raw<N, T>;
  struct Gat {
    Raw<N, T> x1, x3;
    R4<N, T> r;
  };
  using Acc = Vec<N>;
  __device__ static Own zero_own() { return zero_raw<N, T>(); }
  __device__ static Gat zero_gat() {
    return {zero_raw<N, T>(), zero_raw<N, T>(), zero4<N, T>()};
  }
  __device__ static Acc zero() { return filled<N>(0.f); }
  __device__ Own own(int d, int64_t col) const {
    return load_raw<N>(p.aA, (int64_t)d * p.D + col);
  }
  __device__ Gat gather(int c, int a, int64_t col) const {
    const int64_t at = (int64_t)c * p.D + col;
    return {load_raw<N>(p.a1, at), load_raw<N>(p.a3, at),
            load4<N>(p, (int64_t)a * p.D + col)};
  }
  __device__ void add(Acc& acc, const Own& own, const Gat& gat) const {
    const Vec<N> av = widen<N, FAST>(own), x1 = widen<N, FAST>(gat.x1),
                 x3 = widen<N, FAST>(gat.x3);
    const V4<N> r = widen4<N, FAST>(gat.r);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = expo(x1.x[i], av.x[i], r.w.x[i], r.m.x[i]);
      const float ds = dscore(e, x3.x[i], r.gz.x[i], r.goz.x[i]);
      acc.x[i] = add3<FAST>(acc.x[i], ds, x1.x[i], r.w.x[i]);
    }
  }
  __device__ void store(int d, int64_t col, const Acc& acc) const {
    chunk_walk::store<N>(p.out0, (int64_t)d * p.D + col, acc);
  }
};

// The forward of one row longer than F triples, [s0, s1) of row a: its
// maximum, then e, num and den, F triples' gathers at a time in each pass.
template <int N, int F, typename T, bool FAST>
__device__ __noinline__ void forward_long_row(const Params<T, FAST>& p,
                                              int s0, int s1, int a,
                                              int lane, bool active,
                                              int64_t col) {
  const int64_t own = (int64_t)a * p.D + col;
  const Vec<N> w =
      active ? widen<N, FAST>(load_raw<N>(p.a2, own)) : filled<N>(0.f);
  Vec<N> m = filled<N>(-INFINITY), num = filled<N>(0.f),
         den = filled<N>(0.f);
  for (int pass = 0; pass < 2; ++pass) {
    for (int b = s0; b < s1; b += 32) {
      const int n = min(32, s1 - b);
      const int my_u = lane < n ? __ldg(p.u + b + lane) : 0;
      const int my_v = lane < n ? __ldg(p.v + b + lane) : 0;
      for (int j0 = 0; j0 < n; j0 += F) {
        Raw<N, T> rx1[F], rav[F], rx3[F];  // as stored, widened below
#pragma unroll
        for (int q = 0; q < F; ++q) {
          const int j = min(j0 + q, n - 1);
          const int c = __shfl_sync(kFullMask, my_u, j);
          const int d = __shfl_sync(kFullMask, my_v, j);
          rx1[q] = rav[q] = rx3[q] = zero_raw<N, T>();
          if (active && j0 + q < n) {
            rx1[q] = load_raw<N>(p.a1, (int64_t)c * p.D + col);
            rav[q] = load_raw<N>(p.aA, (int64_t)d * p.D + col);
            if (pass == 1)
              rx3[q] = load_raw<N>(p.a3, (int64_t)c * p.D + col);
          }
        }
        if (!active) continue;
#pragma unroll
        for (int q = 0; q < F; ++q) {
          if (j0 + q >= n) break;
          const Vec<N> x1 = widen<N, FAST>(rx1[q]);
          const Vec<N> av = widen<N, FAST>(rav[q]);
          const Vec<N> x3 = widen<N, FAST>(rx3[q]);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            if (pass == 0) {
              m.x[i] = fmaxf(m.x[i], score(x1.x[i], av.x[i], w.x[i]));
            } else {
              const float e = expo(x1.x[i], av.x[i], w.x[i], m.x[i]);
              num.x[i] =
                  __fadd_rn(num.x[i], term<FAST>(__fmul_rn(e, x3.x[i])));
              den.x[i] = __fadd_rn(den.x[i], term<FAST>(e));
            }
          }
        }
      }
    }
  }
  if (active) {
    Vec<N> out;
#pragma unroll
    for (int i = 0; i < N; ++i) out.x[i] = __fdiv_rn(num.x[i], den.x[i]);
    store<N>(p.out0, own, out);
    store<N>(p.out1, own, den);
    store<N>(p.out2, own, m);
  }
}

// The forward of the chunk's rows: whole rows, at most F triples together,
// each gathered row read once; a row of more than F triples alone, by
// forward_long_row.
template <int N, int F, typename T, bool FAST>
__device__ __forceinline__ void forward_walk(const Params<T, FAST>& p,
                                             const chunk_walk::Chunk& ch,
                                             int lane, bool active,
                                             int64_t col) {
  int wb = ch.c0;  // the triple in lane 0
  int my_t = ch.t, my_u = ch.u, my_v = ch.v;
  unsigned starts = ch.starts;  // bit j: triple wb + j starts a row
  int pos = ch.first;           // always a row's first triple
  while (pos < ch.end) {
    if (pos + min(F, ch.end - pos) > wb + 32) {  // the lanes from pos on
      const int shift = pos - wb;
      starts = shift < 32 ? starts >> shift : 0u;
      wb = pos;
      const int q = wb + lane;
      const bool in = q < ch.end;
      my_t = in ? __ldg(p.t + q) : -1;
      my_u = in ? __ldg(p.u + q) : 0;
      my_v = in ? __ldg(p.v + q) : 0;
    }
    const int rel = pos - wb;
    const unsigned after = starts & ~((2u << rel) - 1u);  // starts past pos
    const int row_end = after ? wb + __ffs(after) - 1 : ch.end;
    if (row_end - pos > F) {
      forward_long_row<N, F>(p, pos, row_end,
                             __shfl_sync(kFullMask, my_t, rel), lane,
                             active, col);
      pos = row_end;
      continue;
    }
    // the batch [pos, stop): the whole rows that fit in F triples
    int stop = ch.end;
    if (ch.end - pos > F) {
      const int lim = rel + F;
      const unsigned m = lim >= 31 ? after : after & ((2u << lim) - 1u);
      stop = wb + 31 - __clz(m);
    }
    const int nb = stop - pos;
    // bit q: triple pos + q starts a row (q = 0 does)
    const unsigned rs = ((starts >> rel) & ((1u << nb) - 1u)) | 1u;
    Raw<N, T> rx1[F], rav[F], rx3[F], rw[F];  // as stored, widened below
    int row[F];
#pragma unroll
    for (int q = 0; q < F; ++q) {
      const int j = min(rel + q, 31);
      const int c = __shfl_sync(kFullMask, my_u, j);
      const int d = __shfl_sync(kFullMask, my_v, j);
      row[q] = __shfl_sync(kFullMask, my_t, j);
      rx1[q] = rav[q] = rx3[q] = rw[q] = zero_raw<N, T>();
      if (active && q < nb) {
        rx1[q] = load_raw<N>(p.a1, (int64_t)c * p.D + col);
        rav[q] = load_raw<N>(p.aA, (int64_t)d * p.D + col);
        rx3[q] = load_raw<N>(p.a3, (int64_t)c * p.D + col);
        if ((rs >> q) & 1u)
          rw[q] = load_raw<N>(p.a2, (int64_t)row[q] * p.D + col);
      }
    }
    pos = stop;
    if (!active) continue;
    Vec<N> x1[F], av[F], x3[F], w[F];
#pragma unroll
    for (int q = 0; q < F; ++q) {
      x1[q] = widen<N, FAST>(rx1[q]);
      av[q] = widen<N, FAST>(rav[q]);
      x3[q] = widen<N, FAST>(rx3[q]);
      w[q] = widen<N, FAST>(rw[q]);
    }
    // scores, and the running maximum of each row
    Vec<N> s[F], mx[F], wc = w[0], run = filled<N>(0.f);
#pragma unroll
    for (int q = 0; q < F; ++q) {
      if (q >= nb) break;
      const bool first = (rs >> q) & 1u;
      if (first) wc = w[q];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[q].x[i] = score(x1[q].x[i], av[q].x[i], wc.x[i]);
        run.x[i] = first ? s[q].x[i] : fmaxf(run.x[i], s[q].x[i]);
      }
      mx[q] = run;
    }
    // each triple gets its row's maximum: the running maximum at the row's
    // last triple
#pragma unroll
    for (int q = F - 1; q >= 0; --q) {
      if (q >= nb) continue;
      if (q == nb - 1 || ((rs >> (q + 1)) & 1u)) run = mx[q];
      mx[q] = run;
    }
    Vec<N> num = filled<N>(0.f), den = filled<N>(0.f);
#pragma unroll
    for (int q = 0; q < F; ++q) {
      if (q >= nb) break;
      if ((rs >> q) & 1u) num = den = filled<N>(0.f);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float e = expf(__fsub_rn(s[q].x[i], mx[q].x[i]));
        num.x[i] = __fadd_rn(num.x[i], term<FAST>(__fmul_rn(e, x3[q].x[i])));
        den.x[i] = __fadd_rn(den.x[i], term<FAST>(e));
      }
      if (q == nb - 1 || ((rs >> (q + 1)) & 1u)) {  // the row ends
        Vec<N> out;
#pragma unroll
        for (int i = 0; i < N; ++i) out.x[i] = __fdiv_rn(num.x[i], den.x[i]);
        const int64_t at = (int64_t)row[q] * p.D + col;
        store<N>(p.out0, at, out);
        store<N>(p.out1, at, den);
        store<N>(p.out2, at, mx[q]);
      }
    }
  }
}

// Warps [0, n_chunks) take the chunks, warps [n_chunks, n_warps) store the
// zeros of the empty rows.  N values a lane.
template <int N, Role role, typename T, bool FAST>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_att_kernel(const Params<T, FAST> p) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= p.n_warps) return;  // whole warp leaves together
  if (w >= p.n_chunks) {
    if constexpr (role == kForward) {
      float* const outs[3] = {p.out0, p.out1, p.out2};
      chunk_walk::zero_rows<N, 3>(outs, p.rowptr, p.out_rows,
                                  w - p.n_chunks, lane, p.D);
    } else if constexpr (role == kDC) {
      float* const outs[2] = {p.out0, p.out1};
      chunk_walk::zero_rows<N, 2>(outs, p.rowptr, p.out_rows,
                                  w - p.n_chunks, lane, p.D);
    } else {
      float* const outs[1] = {p.out0};
      chunk_walk::zero_rows<N, 1>(outs, p.rowptr, p.out_rows,
                                  w - p.n_chunks, lane, p.D);
    }
    return;
  }
  chunk_walk::Chunk ch;
  if (!chunk_walk::load_chunk(w, p.chunk, p.k, p.t, p.u, p.v, p.rowptr,
                              lane, ch))
    return;
  constexpr int F = in_flight<role>();
  const int64_t width = p.D / N;  // lanes' worth of a row
  for (int64_t base = 0; base < width; base += 32) {
    const bool active = base + lane < width;  // all lanes join the shuffles
    const int64_t col = (base + lane) * N;     // first value of this lane
    if constexpr (role == kForward) {
      forward_walk<N, F>(p, ch, lane, active, col);
    } else if constexpr (role == kDW) {
      chunk_walk::stream_walk<F>(DwOp<N, T, FAST>{p}, ch, p.u, p.v, lane,
                                 active, col);
    } else if constexpr (role == kDC) {
      chunk_walk::stream_walk<F>(DcOp<N, T, FAST>{p}, ch, p.u, p.v, lane,
                                 active, col);
    } else {
      chunk_walk::stream_walk<F>(DvOp<N, T, FAST>{p}, ch, p.u, p.v, lane,
                                 active, col);
    }
  }
}

template <Role role, typename T, bool FAST>
int launch(Params<T, FAST> p, void* stream) {
  if (p.out_rows <= 0 || p.D <= 0 || p.k < 0 || p.k >= 0x7fffffff - 32 ||
      p.chunk < 1 || p.chunk > 32)
    return (int)cudaErrorInvalidValue;
  p.n_chunks = ((int64_t)p.k + p.chunk - 1) / p.chunk;
  p.n_warps = p.n_chunks + (p.out_rows + chunk_walk::kZeroRows - 1) /
                               chunk_walk::kZeroRows;
  const int64_t blocks = (p.n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  // null pointers (operands a role does not read) count as aligned
  const bool vec =
      p.D % 4 == 0 && chunk_walk::aligned4(p.a1) &&
      chunk_walk::aligned4(p.a3) && chunk_walk::aligned4(p.aA) &&
      chunk_walk::aligned4(p.a2) && chunk_walk::aligned4(p.M) &&
      chunk_walk::aligned4(p.gZ) && chunk_walk::aligned4(p.goZ) &&
      chunk_walk::aligned4(p.out0) && chunk_walk::aligned4(p.out1) &&
      chunk_walk::aligned4(p.out2);
  if (vec) {
    seg_att_kernel<4, role, T, FAST><<<grid, block, 0, s>>>(p);
  } else {
    seg_att_kernel<1, role, T, FAST><<<grid, block, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <Role role, typename T, bool FAST>
int entry(const void* a1, const void* a3, const void* aA, const void* a2,
          const float* M, const float* gZ, const float* goZ, const int* t,
          const int* u, const int* v, const int* rowptr, float* out0,
          float* out1, float* out2, int64_t k, int64_t chunk,
          int64_t out_rows, int64_t D, void* stream) {
  if (k < 0 || k >= 0x7fffffffLL - 32 || chunk < 1 || chunk > 32)
    return (int)cudaErrorInvalidValue;
  const Params<T, FAST> p{static_cast<const T*>(a1),
                          static_cast<const T*>(a3),
                          static_cast<const T*>(aA),
                          static_cast<const T*>(a2),
                          M, gZ, goZ, t, u, v, rowptr, out0, out1, out2,
                          (int)k, (int)chunk, 0, 0, out_rows, D};
  return launch<role>(p, stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

// Every entry point takes the same arguments: a1, a3, a2: (x_rows, D) and
// aA: (e_rows, D), stored as the entry point's name says (f32 or bf16);
// M, gZ, goZ: (x_rows, D) f32 for the gradient roles and null for the
// forward; t, u, v: int32[k], the role's triples sorted by its output row
// t; rowptr: int32[out_rows + 1], the row pointer of t (rowptr[0] == 0,
// rowptr[out_rows] == k); out0, out1, out2: the role's (out_rows, D) f32
// outputs (null where the role has fewer), written in full; chunk: the
// triples of a warp's chunk (1 to 32).  Every index must be in range: the
// caller checks them on the host.  Returns the cudaGetLastError() of the
// launch (0 on success).

#define SEG_ATT_ENTRY(NAME, ROLE, T, FAST)                                  \
  extern "C" int NAME(const void* a1, const void* a3, const void* aA,      \
                      const void* a2, const float* M, const float* gZ,     \
                      const float* goZ, const int* t, const int* u,        \
                      const int* v, const int* rowptr, float* out0,        \
                      float* out1, float* out2, int64_t k, int64_t chunk,  \
                      int64_t out_rows, int64_t D, void* stream) {         \
    return entry<ROLE, T, FAST>(a1, a3, aA, a2, M, gZ, goZ, t, u, v,       \
                                rowptr, out0, out1, out2, k, chunk,        \
                                out_rows, D, stream);                      \
  }

// forward over (a, c, d): t = a, u = c, v = d; out0 = out, out1 = den,
// out2 = M
SEG_ATT_ENTRY(seg_att_fwd_f32, kForward, float, false)
// dw over (a, c, d): t = a, u = c, v = d; out0 = d_a2
SEG_ATT_ENTRY(seg_att_dw_f32, kDW, float, false)
// dc over (c, a, d): t = c, u = a, v = d; out0 = d_a1, out1 = d_a3
SEG_ATT_ENTRY(seg_att_dc_f32, kDC, float, false)
// dv over (d, c, a): t = d, u = c, v = a; out0 = d_aA
SEG_ATT_ENTRY(seg_att_dv_f32, kDV, float, false)

// the same roles in fast mode on f32 operands (rounded as they are read)
SEG_ATT_ENTRY(seg_att_fwd_f32fast, kForward, float, true)
SEG_ATT_ENTRY(seg_att_dw_f32fast, kDW, float, true)
SEG_ATT_ENTRY(seg_att_dc_f32fast, kDC, float, true)
SEG_ATT_ENTRY(seg_att_dv_f32fast, kDV, float, true)

// bf16 operands, exact
SEG_ATT_ENTRY(seg_att_fwd_bf16, kForward, bf16, false)
SEG_ATT_ENTRY(seg_att_dw_bf16, kDW, bf16, false)
SEG_ATT_ENTRY(seg_att_dc_bf16, kDC, bf16, false)
SEG_ATT_ENTRY(seg_att_dv_bf16, kDV, bf16, false)

// bf16 operands, fast
SEG_ATT_ENTRY(seg_att_fwd_bf16fast, kForward, bf16, true)
SEG_ATT_ENTRY(seg_att_dw_bf16fast, kDW, bf16, true)
SEG_ATT_ENTRY(seg_att_dc_bf16fast, kDC, bf16, true)
SEG_ATT_ENTRY(seg_att_dv_bf16fast, kDV, bf16, true)
