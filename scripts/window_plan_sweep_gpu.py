"""K3's time against its window plan's two knobs, on one CUDA card.

    python3 scripts/window_plan_sweep_gpu.py [--out trace_out]

On the giant graph of ``chip_smoke.py`` (``example/giant_graph_gpu.py`` at
200 x 100 communities, D = 128, 556,515 triples), builds the forward, dX
and dA window plans (``build_window_plans``) for each window capacity
``cap`` (rows of a 32-channel V window in shared memory) and group size
``group_triples``, and times each role's kernel (CUDA events, L2 flushed
before each launch, median of 30) beside K1's role on the same triples.
Prints one line a setting, with the rows the plan stages and the rows it
splits across windows, and writes the table as JSON to ``--out``.

It imports nothing of JAX and needs a card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import pygho_tpu_torch  # noqa: E402,F401  (sets the cuBLAS workspace)
import torch  # noqa: E402

CAPS = (256, 512, 1024, 1816)
GROUP_TRIPLES = (1024, 2048, 4096, 8192)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trace_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")

    import numpy as np

    import chip_smoke
    from pygho_tpu_torch.hodata.loader import backward_orders, row_pointer
    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.kernels import window_spspmm as k3

    dev = torch.device("cuda")
    inst = chip_smoke.giant_instance()
    acd, nnz, ne = inst["acd"], inst["nnz_pad"], inst["Av"].shape[0]
    D = chip_smoke.GIANT["hiddim"]
    rng = np.random.default_rng(0)

    def operand(rows):
        return torch.from_numpy(rng.normal(size=(rows, D))
                                .astype(np.float32)).to(dev)

    X, A, g = operand(nnz), operand(ne), operand(nnz)
    flush = torch.empty(64 * 2 ** 20, device=dev).zero_
    operands = {k3.FWD: (X, A), k3.DX: (g, A), k3.DA: (X, g)}

    def ints(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
                .to(dev) for x in xs]

    orders = backward_orders(acd, nnz, ne)
    on_k1 = {k1.FWD: (X, A, *ints(acd, row_pointer(acd[0], nnz))),
             k1.DX: (g, A, *ints(*orders["dx"])),
             k1.DA: (X, g, *ints(*orders["da"]))}
    k1_ms = {r.NAME: chip_smoke.time_ms(
        lambda r=r: k1.contract(r, *on_k1[r]), flush) for r in k1.ROLES}
    print(f"K1 on the same triples (ms): {k1_ms}")
    rows = []
    for cap in CAPS:
        for gt in GROUP_TRIPLES:
            plans = k3.build_window_plans(acd, nnz, ne, nnz, cap=cap,
                                          group_triples=gt)
            line = {"cap": cap, "group_triples": gt}
            for role, plan in zip(k3.ROLES, plans):
                p = plan.to(dev)
                U, V = operands[role]
                ms = chip_smoke.time_ms(
                    lambda: k3.contract(role, U, V, p), flush)
                line[role.NAME] = {
                    "ms": ms, "groups": plan.n_groups,
                    "windows": plan.n_windows,
                    "staged_rows": int(plan.win_rows.sum()),
                    "split_pieces": plan.n_pieces - plan.out_rows}
            rows.append(line)
            print(f"cap {cap:5d}, group_triples {gt:5d}: " + "; ".join(
                f"{n.split('_')[2]} {v['ms']:.4f} ms ({v['groups']} groups, "
                f"{v['staged_rows']} rows staged, {v['split_pieces']} "
                f"split)" for n, v in line.items()
                if isinstance(v, dict)), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "window_plan_sweep_gpu.json").write_text(json.dumps(
        {"card": card, "k1_ms": k1_ms, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
