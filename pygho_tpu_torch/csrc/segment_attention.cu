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
// Each role is one kernel over the role's triples sorted by its output
// row, given as a CSR row pointer over the output rows (rowptr) and the
// two other index arrays (u, v) in that order.  The host builds each
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
// What bounds it on an H100: memory.  Each triple of the forward reads two
// rows (a1[c], aA[d]) in the maximum pass and three (a1[c], aA[d], a3[c])
// in the sum pass; a gradient role reads three to six rows a triple (dv:
// a1, a3, a2, M, gZ, goZ).  Per element that is a handful of
// multiplications and one exp, under one operation a byte, far below the
// roughly 20 operations a byte at which f32 arithmetic would limit it.
// The least traffic is every referenced row of every operand read once,
// the indices read once and every output written once.
//
// What the design does about it (a first version, right before fast):
// - one warp per output row and the feature dim across the lanes, so a
//   row of an operand is read as one coalesced run (float4 loads, 16 bytes
//   a lane, where D % 4 == 0 and every pointer is 16-byte aligned; a
//   scalar loop otherwise, for any D);
// - the row's own operands (a2, M, gZ, goZ in dw; a1, a3 in dc; aA in dv)
//   are loaded once into registers;
// - the warp loads 32 (u, v) index pairs at a time with one coalesced load
//   each and hands them to the lanes by shuffle;
// - no atomics: each row is summed by one warp in triple order, so the
//   result is the same from run to run.  Every product, difference, sum
//   and the final division are rounded on their own (__fmul_rn, __fsub_rn,
//   __fadd_rn, __fdiv_rn: no fused multiply-add), in the order written
//   above, and exp is the accurate expf (no fast math), which is the
//   arithmetic of the plain PyTorch version.
// The forward walks a row's triples twice (maximum, then sums), and every
// gradient role recomputes e; an online maximum, keeping reused rows in
// shared memory and tensor cores are left to a faster version.
//
// Plain C interface (no PyTorch headers), loaded with ctypes: one entry
// point per role, each launching its own instance of the kernel so a
// profile tells the roles apart.  A launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

enum Role { kForward, kDW, kDC, kDV };

struct Params {
  const float* a1;
  const float* a3;
  const float* aA;
  const float* a2;
  const float* M;    // gradient roles only
  const float* gZ;   // gradient roles only
  const float* goZ;  // gradient roles only
  const int* u;      // the role's second index of each triple
  const int* v;      // the role's third index of each triple
  const int* rowptr;
  float* out0;  // forward: out; dw: d_a2; dc: d_a1; dv: d_aA
  float* out1;  // forward: den; dc: d_a3
  float* out2;  // forward: M
  int64_t out_rows;
  int64_t D;
};

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
    *reinterpret_cast<float4*>(p + off) =
        make_float4(r.x[0], r.x[1], r.x[2], r.x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[off + i] = r.x[i];
  }
}

// s = (a1 * aA) * a2, each product rounded
__device__ __forceinline__ float score(float x1, float av, float w) {
  return __fmul_rn(__fmul_rn(x1, av), w);
}

// ds = e * (a3 * gZ - goZ), each step rounded
__device__ __forceinline__ float dscore(float e, float x3, float gz,
                                        float goz) {
  return __fmul_rn(e, __fsub_rn(__fmul_rn(x3, gz), goz));
}

// acc += (p * q) * r, each step rounded
__device__ __forceinline__ float add3(float acc, float p, float q, float r) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(p, q), r));
}

// Walks the triples [start, end) of one row, 32 index pairs at a time, and
// calls body(u, v) for each in order on every lane (the lanes past the
// row's width join the shuffles and skip the body).
template <typename Body>
__device__ __forceinline__ void for_triples(const Params& p, int start,
                                            int end, int lane, bool active,
                                            Body body) {
  for (int t0 = start; t0 < end; t0 += 32) {
    const int n = min(32, end - t0);
    int my_u = 0, my_v = 0;
    if (lane < n) {
      my_u = __ldg(p.u + t0 + lane);
      my_v = __ldg(p.v + t0 + lane);
    }
    for (int j = 0; j < n; ++j) {
      const int uj = __shfl_sync(kFullMask, my_u, j);
      const int vj = __shfl_sync(kFullMask, my_v, j);
      if (active) body(uj, vj);
    }
  }
}

template <int N, Role role>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_att_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.out_rows) return;  // whole warp leaves together
  const int start = p.rowptr[row];
  const int end = p.rowptr[row + 1];
  const int64_t D = p.D;
  const int64_t width = D / N;  // vectors a row
  for (int64_t base = 0; base < width; base += 32) {
    const int64_t col = (base + lane) * N;  // first float of this lane
    const bool active = base + lane < width;
    const int64_t own = row * D + col;
    if constexpr (role == kForward) {
      // the row's a2; then its maximum score, then e, num and den
      const Vec<N> w = active ? load<N>(p.a2, own) : filled<N>(0.f);
      Vec<N> m = filled<N>(-INFINITY);
      for_triples(p, start, end, lane, active, [&](int c, int d) {
        const Vec<N> x1 = load<N>(p.a1, c * D + col);
        const Vec<N> av = load<N>(p.aA, d * D + col);
#pragma unroll
        for (int i = 0; i < N; ++i)
          m.x[i] = fmaxf(m.x[i], score(x1.x[i], av.x[i], w.x[i]));
      });
      if (end == start) m = filled<N>(0.f);
      Vec<N> num = filled<N>(0.f), den = filled<N>(0.f);
      for_triples(p, start, end, lane, active, [&](int c, int d) {
        const Vec<N> x1 = load<N>(p.a1, c * D + col);
        const Vec<N> av = load<N>(p.aA, d * D + col);
        const Vec<N> x3 = load<N>(p.a3, c * D + col);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = expf(
              __fsub_rn(score(x1.x[i], av.x[i], w.x[i]), m.x[i]));
          num.x[i] = __fadd_rn(num.x[i], __fmul_rn(e, x3.x[i]));
          den.x[i] = __fadd_rn(den.x[i], e);
        }
      });
      if (active) {
        Vec<N> out;
#pragma unroll
        for (int i = 0; i < N; ++i)
          out.x[i] = end > start ? __fdiv_rn(num.x[i], den.x[i]) : 0.f;
        store<N>(p.out0, own, out);
        store<N>(p.out1, own, den);
        store<N>(p.out2, own, m);
      }
    } else if constexpr (role == kDW) {
      // row a: its a2, M, gZ, goZ once; a1[c], a3[c], aA[d] a triple
      Vec<N> w, m, gz, goz, acc = filled<N>(0.f);
      if (active) {
        w = load<N>(p.a2, own);
        m = load<N>(p.M, own);
        gz = load<N>(p.gZ, own);
        goz = load<N>(p.goZ, own);
      }
      for_triples(p, start, end, lane, active, [&](int c, int d) {
        const Vec<N> x1 = load<N>(p.a1, c * D + col);
        const Vec<N> x3 = load<N>(p.a3, c * D + col);
        const Vec<N> av = load<N>(p.aA, d * D + col);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = expf(
              __fsub_rn(score(x1.x[i], av.x[i], w.x[i]), m.x[i]));
          const float ds = dscore(e, x3.x[i], gz.x[i], goz.x[i]);
          acc.x[i] = add3(acc.x[i], ds, x1.x[i], av.x[i]);
        }
      });
      if (active) store<N>(p.out0, own, acc);
    } else if constexpr (role == kDC) {
      // row c: its a1, a3 once; a2, M, gZ, goZ of a and aA[d] a triple
      Vec<N> x1, x3, acc1 = filled<N>(0.f), acc3 = filled<N>(0.f);
      if (active) {
        x1 = load<N>(p.a1, own);
        x3 = load<N>(p.a3, own);
      }
      for_triples(p, start, end, lane, active, [&](int a, int d) {
        const int64_t at = a * D + col;
        const Vec<N> w = load<N>(p.a2, at);
        const Vec<N> m = load<N>(p.M, at);
        const Vec<N> gz = load<N>(p.gZ, at);
        const Vec<N> goz = load<N>(p.goZ, at);
        const Vec<N> av = load<N>(p.aA, d * D + col);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = expf(
              __fsub_rn(score(x1.x[i], av.x[i], w.x[i]), m.x[i]));
          const float ds = dscore(e, x3.x[i], gz.x[i], goz.x[i]);
          acc1.x[i] = add3(acc1.x[i], ds, av.x[i], w.x[i]);
          acc3.x[i] = __fadd_rn(acc3.x[i], __fmul_rn(e, gz.x[i]));
        }
      });
      if (active) {
        store<N>(p.out0, own, acc1);
        store<N>(p.out1, own, acc3);
      }
    } else {
      // row d: its aA once; a1, a3 of c and a2, M, gZ, goZ of a a triple
      Vec<N> av, acc = filled<N>(0.f);
      if (active) av = load<N>(p.aA, own);
      for_triples(p, start, end, lane, active, [&](int c, int a) {
        const int64_t at = a * D + col;
        const Vec<N> x1 = load<N>(p.a1, c * D + col);
        const Vec<N> x3 = load<N>(p.a3, c * D + col);
        const Vec<N> w = load<N>(p.a2, at);
        const Vec<N> m = load<N>(p.M, at);
        const Vec<N> gz = load<N>(p.gZ, at);
        const Vec<N> goz = load<N>(p.goZ, at);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = expf(
              __fsub_rn(score(x1.x[i], av.x[i], w.x[i]), m.x[i]));
          const float ds = dscore(e, x3.x[i], gz.x[i], goz.x[i]);
          acc.x[i] = add3(acc.x[i], ds, x1.x[i], w.x[i]);
        }
      });
      if (active) store<N>(p.out0, own, acc);
    }
  }
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

template <Role role>
int launch(const Params& p, void* stream) {
  if (p.out_rows <= 0 || p.D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (p.out_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  // null pointers (operands a role does not read) count as aligned
  const void* ptrs[] = {p.a1, p.a3, p.aA, p.a2, p.M, p.gZ, p.goZ,
                        p.out0, p.out1, p.out2};
  bool vec = p.D % 4 == 0;
  for (const void* q : ptrs) vec = vec && aligned16(q);
  if (vec) {
    seg_att_kernel<4, role><<<grid, block, 0, s>>>(p);
  } else {
    seg_att_kernel<1, role><<<grid, block, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes the same arguments: a1, a3, a2: (x_rows, D) f32;
// aA: (e_rows, D) f32; M, gZ, goZ: (x_rows, D) f32 for the gradient roles
// and null for the forward; u, v: int32[k], the role's second and third
// index of each triple in output-row order; rowptr: int32[out_rows + 1]
// with rowptr[0] == 0 and rowptr[out_rows] == k; out0, out1, out2: the
// role's (out_rows, D) f32 outputs (null where the role has fewer).  Every
// index must be in range: the caller checks them on the host.  Returns the
// cudaGetLastError() of the launch (0 on success).

#define SEG_ATT_ENTRY(NAME, ROLE)                                           \
  extern "C" int NAME(const float* a1, const float* a3, const float* aA,   \
                      const float* a2, const float* M, const float* gZ,    \
                      const float* goZ, const int* u, const int* v,        \
                      const int* rowptr, float* out0, float* out1,         \
                      float* out2, int64_t out_rows, int64_t D,            \
                      void* stream) {                                      \
    const Params p{a1, a3, aA, a2, M, gZ, goZ, u, v, rowptr,               \
                   out0, out1, out2, out_rows, D};                         \
    return launch<ROLE>(p, stream);                                        \
  }

// forward over (a, c, d): u = c, v = d; out0 = out, out1 = den, out2 = M
SEG_ATT_ENTRY(seg_att_fwd_f32, kForward)
// dw over (a, c, d): u = c, v = d; out0 = d_a2
SEG_ATT_ENTRY(seg_att_dw_f32, kDW)
// dc over (c, a, d): u = a, v = d; out0 = d_a1, out1 = d_a3
SEG_ATT_ENTRY(seg_att_dc_f32, kDC)
// dv over (d, c, a): u = c, v = a; out0 = d_aA
SEG_ATT_ENTRY(seg_att_dv_f32, kDV)
