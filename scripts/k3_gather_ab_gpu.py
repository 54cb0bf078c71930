"""K3's two ways of hiding gather latency, timed side by side on the card.

    python3 scripts/k3_gather_ab_gpu.py [--out trace_out]

K3 (``pygho_tpu_torch/csrc/window_spspmm.cu``) gives each warp a chunk of
short output rows and must keep several triples' row gathers in flight
before their adds.  Two designs do that:

- ``regs``: the gathers of ``kInFlight`` triples unrolled into registers
  (the package's kernel, ``regs8``; also built here from edited copies of
  its source: ``kInFlight`` = 4 and 16, at most 85 registers a thread so
  that three blocks share an SM (``regs8_lb3``), output rows stored
  without the package's evict-first hint ``__stcs`` (``regs8_st``), and
  the gathers read through L2 only with ``__ldcg`` (``regs8_cg``));
- ``ring``: each lane's 16 bytes of both rows copied by ``cp.async`` into
  a per-warp ring of ``RING`` triples in shared memory (this script's own
  source below, ``RING`` = 4, 8, 16), each triple's copies a commit group,
  read back after ``cp.async.wait_group``; its rows are stored with
  ``__stcs``, as the package's.

Both take the package's plans (``build_chunk_plans``), walk the rows in
the same order and do the same arithmetic.  On the giant graph of
``chip_smoke.py`` (200 x 100 communities, 556,515 triples, D = 128), for
the forward, dX and dA roles, every variant and K1 on the same triples are
held bit for bit against the plain version and timed with the L2 flushed
before each launch (median of 30 CUDA-event-timed launches), twice, in
the order of the list and then in reverse.  Prints one line a timing and
writes ``k3_gather_ab.json`` to ``--out``.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

RING_SOURCE = r"""
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

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ring_kernel(const T* __restrict__ U, const T* __restrict__ V,
            const int* __restrict__ u, const int* __restrict__ v,
            const int* __restrict__ rowptr, const int* __restrict__ warp_row,
            T* __restrict__ out, int64_t n_warps, int64_t width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  // this warp's ring: RING slots of [U piece][V piece], 32 lanes each
  T* ring = reinterpret_cast<T*>(smem) + (threadIdx.x >> 5) * RING * 64;
  const int64_t w =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const int r0 = __ldg(warp_row + w);
  const int rows = __ldg(warp_row + w + 1) - r0;
  const int my_end = lane < rows ? __ldg(rowptr + r0 + 1 + lane) : 0;
  const int t0 = __ldg(rowptr + r0);
  const int t1 = __shfl_sync(kFullMask, my_end, rows - 1);
  for (int64_t base = 0; base < width; base += 32) {
    const int64_t col = base + lane;
    const bool active = col < width;
    T* o = out + (int64_t)r0 * width + col;
    int ri = 0;
    int end = __shfl_sync(kFullMask, my_end, 0);
    T acc = zero_of(T());
    for (int c0 = t0; c0 < t1; c0 += 32) {
      const int n = min(32, t1 - c0);
      int my_u = 0, my_v = 0;
      if (lane < n) {
        my_u = __ldg(u + c0 + lane);
        my_v = __ldg(v + c0 + lane);
      }
      auto issue = [&](int j) {  // triple j's two rows into its slot
        const int jj = min(j, n - 1);
        const int uj = __shfl_sync(kFullMask, my_u, jj);
        const int vj = __shfl_sync(kFullMask, my_v, jj);
        T* s = ring + (j % RING) * 64;
        const bool ok = active && j < n;
        copy_async<sizeof(T)>(s + lane, ok ? U + (int64_t)uj * width + col
                                           : U, ok);
        copy_async<sizeof(T)>(s + 32 + lane,
                              ok ? V + (int64_t)vj * width + col : V, ok);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
#pragma unroll
      for (int j = 0; j < RING - 1; ++j) issue(j);
      for (int j = 0; j < n; ++j) {
        issue(j + RING - 1);  // into the slot summed last iteration
        wait_pending<RING - 1>();
        const T x = ring[(j % RING) * 64 + lane];
        const T y = ring[(j % RING) * 64 + 32 + lane];
        const int t = c0 + j;
        while (t >= end) {
          if (active) __stcs(o + (int64_t)ri * width, acc);
          acc = zero_of(T());
          ++ri;
          end = __shfl_sync(kFullMask, my_end, ri);
        }
        if (active) acc = mul_add(acc, x, y);
      }
      wait_pending<0>();
    }
    for (; ri < rows; ++ri) {
      if (active) __stcs(o + (int64_t)ri * width, acc);
      acc = zero_of(T());
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int run(const T* U, const T* V, const int* u, const int* v,
        const int* rowptr, const int* warp_row, T* out, int64_t n_warps,
        int64_t width, cudaStream_t s) {
  const int smem = kWarpsPerBlock * RING * 64 * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ring_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, smem, s>>>(
      U, V, u, v, rowptr, warp_row, out, n_warps, width);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ring_f32(const float* U, const float* V, const int* u,
                        const int* v, const int* rowptr, const int* warp_row,
                        float* out, int64_t n_warps, int64_t D,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(U) && aligned16(V) && aligned16(out))
    return run<float4>(reinterpret_cast<const float4*>(U),
                       reinterpret_cast<const float4*>(V), u, v, rowptr,
                       warp_row, reinterpret_cast<float4*>(out), n_warps,
                       D / 4, s);
  return run<float>(U, V, u, v, rowptr, warp_row, out, n_warps, D, s);
}
"""


def build(out_dir):
    """The variants' libraries, built with all nvcc processes at once and
    loaded: {name: ctypes.CDLL}."""
    from pygho_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    src_dir = out_dir / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
    pkg = (_build.CSRC_DIR / "window_spspmm.cu").read_text()
    edits = {
        "regs4": [(r"kInFlight = 8;", "kInFlight = 4;", 1)],
        "regs16": [(r"kInFlight = 8;", "kInFlight = 16;", 1)],
        "regs8_lb3": [(r"__launch_bounds__\(kWarpsPerBlock \* 32\)",
                       "__launch_bounds__(kWarpsPerBlock * 32, 3)", 1)],
        "regs8_st": [(re.escape("__stcs(o + (int64_t)ri * width, acc)"),
                      "o[(int64_t)ri * width] = acc", 2)],
        "regs8_cg": [(r"__ldg\(([UV]) \+", r"__ldcg(\1 +", 2)],
    }
    sources = {}
    for name, subs in edits.items():
        text = pkg
        for pattern, repl, count in subs:
            text, hits = re.subn(pattern, repl, text)
            if hits != count:
                raise RuntimeError(f"{name}: {pattern!r} matched {hits} "
                                   f"times in window_spspmm.cu")
        sources[name] = (text, [])
    for ring in (4, 8, 16):
        sources[f"ring{ring}"] = (RING_SOURCE, [f"-DRING={ring}"])
    procs = {}
    for name, (text, defs) in sources.items():
        src = src_dir / f"{name}.cu"
        src.write_text(text)
        lib = src_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *defs, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "registers" in line or "spill" in line \
                    or "Function properties" in line:
                print(f"  {name}: {line.strip()}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="trace_out")
    args = parser.parse_args()
    out_dir = Path(args.out) / "k3_gather_ab"

    import numpy as np
    import torch

    import chip_smoke
    from pygho_tpu_torch.kernels import _build
    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.kernels import window_spspmm as k3
    from pygho_tpu_torch.models.serve import set_parity_numerics

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on a "
                         "card")
    dev = torch.device("cuda")
    # deterministic algorithms: the plain version's index_add_ then sums
    # each row in triple order, as the kernels do
    set_parity_numerics()
    card = chip_smoke.card_line()
    print(f"card: {card}")
    _build.build(["window_spspmm", "spspmm_sum"])
    libs = build(out_dir)

    inst = chip_smoke.giant_instance()
    acd, nnz, ne = inst["acd"], inst["nnz_pad"], inst["Av"].shape[0]
    D = chip_smoke.GIANT["hiddim"]
    plans = [p.to(dev) for p in k3.build_chunk_plans(acd, nnz, ne, nnz)]
    rng = np.random.default_rng(0)
    n_t = inst["tup"].shape[1]

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    X, A, g = operand(nnz, n_t), operand(ne, ne), operand(nnz, n_t)
    operands = {k3.FWD: (X, A), k3.DX: (g, A), k3.DA: (X, g)}
    flush_buf = torch.empty(64 * 2 ** 20, device=dev)

    def raw(lib, entry, U, V, plan):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.empty(plan.out_rows, D, device=dev)
        rc = fn(U.data_ptr(), V.data_ptr(), plan.tuv[1].data_ptr(),
                plan.tuv[2].data_ptr(), plan.rowptr.data_ptr(),
                plan.warp_row.data_ptr(), out.data_ptr(), plan.n_warps, D,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
        return out

    results = []
    for role, r1, plan in zip(k3.ROLES, k1.ROLES, plans):
        U, V = operands[role]
        tuv = plan.tuv
        k1_args = (U, V, tuv, plan.rowptr)
        variants = {"regs8": lambda: k3.contract(role, U, V, plan)}
        for name, lib in libs.items():
            entry = role.NAME if name.startswith("regs") else "ring_f32"
            variants[name] = (lambda lib=lib, entry=entry:
                              raw(lib, entry, U, V, plan))
        variants["K1"] = lambda: k1.contract(r1, *k1_args)
        ref = k1.contract_plain(U, V, tuv, plan.out_rows)
        bitwise = {}
        for name, fn in variants.items():
            out = fn()
            torch.cuda.synchronize()
            bitwise[name] = bool(torch.equal(out, ref))
        times = {name: [] for name in variants}
        order = list(variants)
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(chip_smoke.time_ms(variants[name],
                                                      flush_buf.zero_))
        bound_ms = chip_smoke.k1_bound(tuv, plan.out_rows, D)[0]
        for name in order:
            print(f"{role.NAME} {name}: {times[name][0]:.4f} / "
                  f"{times[name][1]:.4f} ms (in turns), bitwise equal to "
                  f"the plain version: {bitwise[name]}; bound "
                  f"{bound_ms:.4f} ms")
            results.append({"role": role.NAME, "variant": name,
                            "ms": times[name], "bitwise": bitwise[name],
                            "bound_ms": bound_ms})
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k3_gather_ab.json").write_text(json.dumps(
        {"card": card, "results": results}, indent=1))
    if not all(r["bitwise"] for r in results):
        raise SystemExit("a variant differs from the plain version")


if __name__ == "__main__":
    main()
