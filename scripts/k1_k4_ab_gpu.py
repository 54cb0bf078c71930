"""K1 and K4 on the main path's batch: the chunked designs against the
first ones, timed side by side on the card.

    python3 scripts/k1_k4_ab_gpu.py [--out trace_out] [--rounds 3]

K1 (``pygho_tpu_torch/csrc/spspmm_sum.cu``) and K4
(``csrc/segment_attention.cu``) give each warp a chunk of C triples and
issue the gathers of F triples at once (``csrc/chunk_walk.cuh``).  This
script builds, beside the package's kernels, all ``nvcc`` processes at
once:

- the first designs, a warp an output row (``k1_first``, ``k4_first``:
  their sources are kept below, as they were before the chunks);
- the chunked designs with other F, from edited copies of the package's
  sources (``K1_VARIANTS``: F = 4, 8 and 16, and 8 held to six blocks an
  SM; ``K4_VARIANTS``: F = 4 or 8 for the forward and dw with 2 or 4 for
  dc and dv, and the first held to four blocks an SM);

and prints each kernel's registers, stack and spills from ``-Xptxas -v``.
C (8, 16 or 32) is an argument of the chunked kernels, so one build serves
every C.  On one 128-graph batch of ``synthetic_zinc("val")`` with
``KhopSampler(hop=3)`` (60,224 triples, D = 128, as ``chip_smoke.py``
builds it), for each role of K1 (fwd, dX, dA) and of K4 (fwd, dw, dc, dv),
every variant is held bit for bit against the plain version, then timed
as ``chip_smoke.py`` times kernels: one launch between CUDA events with
the L2 flushed before it, median of 30, ``--rounds`` times in the order of
the list, then reversed, and so on; and once with its inputs left in L2.
K1's roles are also timed as K3's kernel (``kernels/window_spspmm.py``,
host-built chunks of 32 triples) on the same triples.  Probes: K1 and K4
with every gather on row 0 (the schedule and the stores with almost no
gather traffic), a launch with nothing to do, and one that only stores the
zeros of 32,768 rows.  Last, every run's kernel is timed again under
``torch.profiler`` (mean device time of ``PROFILE_REPS`` launches, L2
flushed before each): the kernel alone, without the launch and the events
that the CUDA-event time includes.  Prints one line a timing and writes
``k1_k4_ab.json`` to ``--out``.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# K1 as it was before the chunks: a warp an output row, (u, v) pairs 32 at
# a time by shuffle, four triples' gathers unrolled
K1_FIRST = r"""
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


extern "C" int spspmm_sum_fwd_f32(const float* U, const float* V,
                                  const int* c, const int* d,
                                  const int* rowptr, float* out,
                                  int64_t out_rows, int64_t D,
                                  void* stream) {
  return launch<kForward>(U, V, c, d, rowptr, out, out_rows, D, stream);
}

extern "C" int spspmm_sum_dx_f32(const float* U, const float* V,
                                 const int* c, const int* d,
                                 const int* rowptr, float* out,
                                 int64_t out_rows, int64_t D, void* stream) {
  return launch<kDX>(U, V, c, d, rowptr, out, out_rows, D, stream);
}

extern "C" int spspmm_sum_da_f32(const float* U, const float* V,
                                 const int* c, const int* d,
                                 const int* rowptr, float* out,
                                 int64_t out_rows, int64_t D, void* stream) {
  return launch<kDA>(U, V, c, d, rowptr, out, out_rows, D, stream);
}
"""

# K4 as it was before the chunks: a warp an output row, one triple's
# gathers at a time, the forward walking each row twice
K4_FIRST = r"""
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

__device__ __forceinline__ float score(float x1, float av, float w) {
  return __fmul_rn(__fmul_rn(x1, av), w);
}

__device__ __forceinline__ float dscore(float e, float x3, float gz,
                                        float goz) {
  return __fmul_rn(e, __fsub_rn(__fmul_rn(x3, gz), goz));
}

__device__ __forceinline__ float add3(float acc, float p, float q, float r) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(p, q), r));
}

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

SEG_ATT_ENTRY(seg_att_fwd_f32, kForward)
SEG_ATT_ENTRY(seg_att_dw_f32, kDW)
SEG_ATT_ENTRY(seg_att_dc_f32, kDC)
SEG_ATT_ENTRY(seg_att_dv_f32, kDV)
"""

CHUNKS = (8, 16, 32)
# K1's variants: its F (one for every role) and the blocks an SM the
# compiler must fit (lb; none: as it likes)
K1_VARIANTS = {"f4": dict(f=(4,)), "f8": dict(f=(8,)), "f16": dict(f=(16,)),
               "f8_lb6": dict(f=(8,), lb=6)}
# K4's variants: F of (fwd, dw, dc, dv) and lb
K4_VARIANTS = {"lo": dict(f=(4, 4, 2, 2)), "hi": dict(f=(8, 8, 4, 4)),
               "lo_lb4": dict(f=(4, 4, 2, 2), lb=4)}
# the names of the F constants in each source
K1_ROLES = ("",)
K4_ROLES = ("Fwd", "DW", "DC", "DV")


# launches a variant's device time is the mean of
PROFILE_REPS = 20
# the kernels' symbols, in the profiler's names of their launches
KERNEL_SYMBOLS = ("spspmm_sum_kernel", "seg_att_kernel",
                  "window_spspmm_kernel")


def edited(text, roles, what, f, lb=None):
    """A copy of a package source with F = f[i] for role i and, where lb
    is given, a launch bound of lb blocks an SM."""
    for role, fi in zip(roles, f):
        name = f"kInFlight{role}"
        text, n = re.subn(rf"{name} = \d+;", f"{name} = {fi};", text)
        if n != 1:
            raise RuntimeError(f"{name} not found in {what}")
    if lb:
        text, n = re.subn(r"__launch_bounds__\(kWarpsPerBlock \* 32\)",
                          f"__launch_bounds__(kWarpsPerBlock * 32, {lb})",
                          text)
        if n != 1:
            raise RuntimeError(f"__launch_bounds__ not found in {what}")
    return text


def variant_sources(k1_pkg, k4_pkg):
    """{library name: source} of every variant built beside the package."""
    sources = {"k1_first": K1_FIRST, "k4_first": K4_FIRST}
    for name, spec in K1_VARIANTS.items():
        sources[f"k1_{name}"] = edited(k1_pkg, K1_ROLES, "spspmm_sum.cu",
                                       **spec)
    for name, spec in K4_VARIANTS.items():
        sources[f"k4_{name}"] = edited(k4_pkg, K4_ROLES,
                                       "segment_attention.cu", **spec)
    return sources


def build(out_dir):
    """Every variant's library, all nvcc processes at once:
    {name: ctypes.CDLL}; prints each kernel's registers and spills."""
    from pygho_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    src_dir = out_dir / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
    k1_pkg = (_build.CSRC_DIR / "spspmm_sum.cu").read_text()
    k4_pkg = (_build.CSRC_DIR / "segment_attention.cu").read_text()
    sources = variant_sources(k1_pkg, k4_pkg)
    procs = {}
    for name, text in sources.items():
        src = src_dir / f"{name}.cu"
        src.write_text(text)
        lib = src_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, regs = {}, {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            if kernel and ("registers" in line or "spill" in line):
                info = re.sub(r"^ptxas info\s*:\s*", "", line.strip())
                print(f"  {name} {kernel}: {info}")
                regs.setdefault(name, {}).setdefault(kernel, []).append(info)
        libs[name] = ctypes.CDLL(str(lib))
    return libs, regs


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="trace_out")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    out_dir = Path(args.out) / "k1_k4_ab"

    import numpy as np
    import torch

    import chip_smoke
    from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                        Sppretransform, synthetic_zinc)
    from pygho_tpu_torch.kernels import _build
    from pygho_tpu_torch.kernels import segment_attention as k4
    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.kernels import window_spspmm as k3
    from pygho_tpu_torch.models.serve import set_parity_numerics

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a "
                         "card")
    dev = torch.device("cuda")
    # deterministic algorithms: the plain versions' index_add_ then sum
    # each row in triple order, as the kernels do
    set_parity_numerics()
    card = chip_smoke.card_line()
    print(f"card: {card}")
    _build.build(["spspmm_sum", "segment_attention", "window_spspmm"])
    for name in ("spspmm_sum", "segment_attention"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"  package {name}: {line.strip()}")
    libs, regs = build(out_dir)

    key = chip_smoke.KEY
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [key])
    datas = [pre(g) for g in synthetic_zinc("val", seed=chip_smoke.SEED)]
    batch = next(iter(SpDataloader(datas, 128, [key], backward=True)))
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    n_t, n_e = int(batch["num_tuples"]), int(batch["num_edges"])
    D = 128
    rng = np.random.default_rng(0)

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    t = {name: torch.from_numpy(batch[f"{key}___{name}"]).to(dev)
         for name in ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da",
                      "rowptr_da")}
    flush = torch.empty(64 * 2 ** 20, device=dev).zero_
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def entry(lib, name, nargs):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * nargs[0] \
            + [ctypes.c_int64] * nargs[1] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def called(fn, *a):
        rc = fn(*a)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def race(label, variants, ref, bound_ms):
        """Bit for bit against ref, then timed in turns (L2 flushed), and
        once with the inputs left in L2 (the card spins in place before
        the launch, so the time is the kernel's)."""
        bitwise = {}
        for name, fn in variants.items():
            got = fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            bitwise[name] = all(bool(torch.equal(x, r))
                                for x, r in zip(got, ref))
        times = {name: [] for name in variants}
        order = list(variants)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(chip_smoke.time_ms(variants[name], flush))
        warm = {name: chip_smoke.time_ms(
            fn, lambda: torch.cuda._sleep(1_000_000))
            for name, fn in variants.items()}
        rows = []
        for name in order:
            med = statistics.median(times[name])
            print(f"{label} {name}: " + " / ".join(f"{x:.4f}"
                                                   for x in times[name])
                  + f" ms (in turns; median {med:.4f}, {bound_ms / med:.0%} "
                  f"of the bound {bound_ms:.4f} ms); inputs left in L2 "
                  f"{warm[name]:.4f} ms; bitwise equal to the plain "
                  f"version: {bitwise[name]}", flush=True)
            rows.append({"role": label, "variant": name, "ms": times[name],
                         "median_ms": med, "warm_ms": warm[name],
                         "bound_ms": bound_ms, "bitwise": bitwise[name]})
            pending.append((rows[-1], variants[name]))
        return rows

    # the runs whose kernels are timed under the profiler at the end, once
    # every CUDA-event timing is taken (profiling slows the host's launches)
    pending = []
    results = []

    def device_ms(fn, reps=PROFILE_REPS):
        """The mean device time of the kernel a call of fn launches, the
        L2 flushed before each call, from torch.profiler's kernel records
        (the flush's own kernel left out): no launch gap, no event."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages()
                    if any(k in e.key for k in KERNEL_SYMBOLS))
        return total / reps / 1e3

    def probe(label, what, fn, bound_ms):
        """One timing with the L2 flushed and one with the inputs left in
        L2, of a run that is no variant of the race."""
        cold = chip_smoke.time_ms(fn, flush)
        warm = chip_smoke.time_ms(fn, lambda: torch.cuda._sleep(1_000_000))
        print(f"{label} {what}: {cold:.4f} ms (L2 flushed), {warm:.4f} ms "
              f"(inputs left in L2)", flush=True)
        results.append({"role": label, "variant": what, "ms": [cold],
                        "median_ms": cold, "warm_ms": warm,
                        "bound_ms": bound_ms, "bitwise": True,
                        "probe": True})
        pending.append((results[-1], fn))

    # The variants' runs: every input is bound when a run is made, since
    # the runs are called again, under the profiler, after the loops.
    def k1_first(role, L, R, tv, rowptr):
        fn = entry(libs["k1_first"], role.NAME, (6, 2))
        rows = rowptr.shape[0] - 1

        def run():
            out = torch.empty(rows, D, device=dev)
            called(fn, L.data_ptr(), R.data_ptr(), tv[1].data_ptr(),
                   tv[2].data_ptr(), rowptr.data_ptr(), out.data_ptr(),
                   rows, D, stream())
            return out
        return run

    def k1_chunked(lib, C, role, L, R, tv, rowptr):
        fn = entry(lib, role.NAME, (7, 4))
        rows = rowptr.shape[0] - 1

        def run():
            out = torch.empty(rows, D, device=dev)
            called(fn, L.data_ptr(), R.data_ptr(), tv[0].data_ptr(),
                   tv[1].data_ptr(), tv[2].data_ptr(), rowptr.data_ptr(),
                   out.data_ptr(), tv.shape[1], C, rows, D, stream())
            return out
        return run

    # K1: forward out[a] += U[c] * V[d], dX dU[c] += g[a] * V[d], dA
    # dV[d] += U[c] * g[a]
    U, V, g = operand(nt, n_t), operand(ne, n_e), operand(nt, n_t)
    k1_main = {k1.FWD: (U, V, t["acd"], t["rowptr"]),
               k1.DX: (g, V, t["acd_dx"], t["rowptr_dx"]),
               k1.DA: (U, g, t["acd_da"], t["rowptr_da"])}
    k3_roles = dict(zip(k1.ROLES, k3.ROLES))
    for role, (L, R, tuv, rowptr) in k1_main.items():
        rows = rowptr.shape[0] - 1
        ref = (k1.contract_plain(L, R, tuv, rows),)
        variants = {"first": k1_first(role, L, R, tuv, rowptr)}
        for fname in K1_VARIANTS:
            for C in CHUNKS:
                variants[f"C{C}_{fname}"] = k1_chunked(
                    libs[f"k1_{fname}"], C, role, L, R, tuv, rowptr)
        plan = k3.build_chunk_plan(tuv.cpu().numpy(), rows, L.shape[0],
                                   R.shape[0]).to(dev)
        variants["K3"] = partial(k3.contract, k3_roles[role], L, R, plan)
        variants["package"] = partial(k1.contract, role, L, R, tuv, rowptr)
        bound_ms = chip_smoke.k1_bound(tuv, rows, D)[0]
        results += race(role.NAME, variants, ref, bound_ms)
        # the same rows and triples with every gather on row 0: what the
        # schedule costs with (almost) no memory traffic but the stores
        one = tuv.clone()
        one[1:].zero_()
        probe(role.NAME, "first, every gather on row 0",
              k1_first(role, L, R, one, rowptr), bound_ms)
        probe(role.NAME, "package, every gather on row 0",
              partial(k1.contract, role, L, R, one, rowptr), bound_ms)

    n_out = {k4.FWD: 3, k4.DW: 1, k4.DC: 2, k4.DV: 1}

    def k4_run(fn, role, ins, rowptr, idx, tail):
        """A run of a K4 library's role: its inputs, the index arrays
        idx, the row pointer, fresh outputs, then the integers tail."""
        rows = rowptr.shape[0] - 1

        def run():
            o = [torch.empty(rows, D, device=dev)
                 for _ in range(n_out[role])]
            po = [x.data_ptr() for x in o] + [None] * (3 - len(o))
            called(fn, *ins, *[x.data_ptr() for x in idx],
                   rowptr.data_ptr(), *po, *tail, stream())
            return tuple(o)
        return run

    # K4 on random operands; M, gZ, goZ from the plain forward
    ops = (operand(nt, n_t), operand(nt, n_t), operand(ne, n_e),
           operand(nt, n_t))
    out, den, M = k4.attention_plain(k4.FWD, *ops, t["acd"], nt)
    gZ, goZ = k4.softmax_cotangents(operand(nt, n_t), out, den)
    k4_main = {k4.FWD: (t["acd"], t["rowptr"], None, None, None),
               k4.DW: (t["acd"], t["rowptr"], M, gZ, goZ),
               k4.DC: (t["acd_dx"], t["rowptr_dx"], M, gZ, goZ),
               k4.DV: (t["acd_da"], t["rowptr_da"], M, gZ, goZ)}
    for role, (tuv, rowptr, *grads) in k4_main.items():
        rows = rowptr.shape[0] - 1
        ref = k4.attention_plain(role, *ops, tuv, rows, *grads)
        ins = [x.data_ptr() if x is not None else None
               for x in (*ops, *grads)]
        variants = {"first": k4_run(
            entry(libs["k4_first"], role.NAME, (13, 2)), role, ins, rowptr,
            (tuv[1], tuv[2]), (rows, D))}
        for fname in K4_VARIANTS:
            for C in CHUNKS:
                variants[f"C{C}_{fname}"] = k4_run(
                    entry(libs[f"k4_{fname}"], role.NAME, (14, 4)), role,
                    ins, rowptr, (tuv[0], tuv[1], tuv[2]),
                    (tuv.shape[1], C, rows, D))
        variants["package"] = partial(k4.attend, role, *ops, tuv, rowptr,
                                      *grads)
        bound_ms = chip_smoke.k4_bound(role, tuv, rowptr, D)[0]
        results += race(role.NAME, variants, ref, bound_ms)
        one = tuv.clone()
        one[1:].zero_()
        probe(role.NAME, "package, every gather on row 0", partial(
            k4.attend, role, *ops, one, rowptr, *grads), bound_ms)

    # floors: a launch with nothing to do, and one that only stores the
    # zeros of 32,768 empty rows (16.8 MB)
    none = torch.zeros(3, 0, dtype=torch.int32, device=dev)
    for what, rows in (("one empty row", 1), ("32,768 empty rows", nt)):
        rp = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
        probe(k1.FWD.NAME, f"package, no triples, {what}",
              partial(k1.contract, k1.FWD, U, V, none, rp), 0.0)

    for row, fn in pending:
        row["device_ms"] = device_ms(fn)
        share = f", {row['bound_ms'] / row['device_ms']:.0%} of the bound" \
            if row["bound_ms"] and row["device_ms"] else ""
        print(f"device {row['role']} {row['variant']}: kernel "
              f"{row['device_ms']:.4f} ms{share}", flush=True)

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k1_k4_ab.json").write_text(json.dumps(
        {"card": card, "k1_variants": K1_VARIANTS,
         "k4_variants": K4_VARIANTS, "registers": regs,
         "results": results}, indent=1))
    for key in ("median_ms", "device_ms"):
        best = {}
        for r in results:
            if r["variant"] in ("package", "K3") or r.get("probe") \
                    or not r.get(key):
                continue
            if r["role"] not in best or r[key] < best[r["role"]][key]:
                best[r["role"]] = r
        print(json.dumps({f"best by {key}": {
            role: r["variant"] for role, r in best.items()}}))
    if not all(r["bitwise"] for r in results):
        raise SystemExit("a variant differs from the plain version")


if __name__ == "__main__":
    main()
