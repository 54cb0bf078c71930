"""The entry points that run I2GNN, on the CPU: ``example/zinc_gpu.py
--sparse --conv I2GNN`` (with and without ``--fused``) and
``example/expressivity_gpu.py --dataset count --conv I2GNN``, each at 2
layers x 32 for one epoch, their records, and what the count entry point
refuses.  The model itself against the JAX package:
``tests/test_torch_i2gnn_models.py``.
"""

import io
import json
import math
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from pygho_tpu.hodata import datasets as jx_datasets

from pygho_tpu_torch.kernels import get_fused_math

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "example"))
import expressivity_gpu  # noqa: E402
import zinc_gpu  # noqa: E402


@pytest.mark.parametrize("fused", [False, True])
def test_zinc_gpu_trains_sparse_i2gnn(tmp_path, fused):
    """``zinc_gpu.py --cpu --sparse --conv I2GNN [--fused]`` at 2x32 for
    one epoch on 32 graphs: ``I2Sampler`` preprocessing cached under its
    own tag, the jsonl records, a finite test MAE in the converged record,
    and the math mode restored after the run."""
    argv = ["--cpu", "--sparse", "--conv", "I2GNN", "--num_layer", "2",
            "--hiddim", "32", "--epochs", "1", "--ntrain", "32", "--bs",
            "16", "--cache-dir", str(tmp_path / "cache"), "--log-dir",
            str(tmp_path / "logs"), "--converged-record",
            str(tmp_path / "rec.json")] + (["--fused"] if fused else [])
    with redirect_stdout(io.StringIO()):
        scores = zinc_gpu.main(argv)
    assert get_fused_math() is True
    assert len(scores) == 1 and math.isfinite(scores[0])
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["conv"] == "I2GNN" and rec["fused"] is fused
    assert rec["mode"] == "sparse" and rec["best_val_mae"] is not None
    caches = sorted(os.listdir(tmp_path / "cache"))
    assert caches == ["SYNZINC_sp_I2GNN_h3_test", "SYNZINC_sp_I2GNN_h3_train"
                      "_n32", "SYNZINC_sp_I2GNN_h3_val"]
    lines = (tmp_path / "logs" / "zinc_gpu_sp_I2GNN_h3_r0.jsonl") \
        .read_text().splitlines()
    assert [json.loads(x)["type"] for x in lines] == ["padding", "epoch",
                                                      "telemetry"]


def test_expressivity_gpu_trains_the_count_task(tmp_path):
    """``expressivity_gpu.py --cpu --dataset count --conv I2GNN`` at 2x32
    for one epoch at batch 64, with the cosine schedule and the BatchNorm
    recalibration: the JAX script's split of the 512 graphs (the same
    triangle targets), its per-epoch record, a finite validation MAE and
    the summary record."""
    log = tmp_path / "logs" / "expr_gpu_count_triangle_I2GNN.jsonl"
    record = tmp_path / "expr.json"
    argv = ["--cpu", "--dataset", "count", "--conv", "I2GNN", "--num_layer",
            "2", "--hiddim", "32", "--epochs", "1", "--bs", "64", "--cosT",
            "26", "--lr", "3.4e-3", "--normparam", "0.31",
            "--recalibrate_bn", "--cache-dir", str(tmp_path / "cache"),
            "--log-dir", str(tmp_path / "logs"), "--converged-record",
            str(record)]
    out = io.StringIO()
    with redirect_stdout(out):
        rec = expressivity_gpu.main(argv)
    n_graphs = len(jx_datasets.synthetic_subgraphcount())
    assert rec["n_val"] == n_graphs // 5
    assert rec["n_train"] + rec["n_val"] == n_graphs
    assert rec["dataset"] == "count_triangle" and rec["best_val_epoch"] == 1
    assert math.isfinite(rec["best_val_mae"])
    assert json.loads(record.read_text()) == rec
    (line,) = [json.loads(x) for x in log.read_text().splitlines()]
    assert line["type"] == "epoch" and line["epoch"] == 1
    assert line["mae"] == rec["best_val_mae"] and math.isfinite(line["loss"])
    assert "Final count_triangle mae:" in out.getvalue()


@pytest.mark.parametrize("argv,why", [
    (["--dataset", "CSL"], "item 10)"),
    (["--dataset", "EXP"], "item 10)"),
    (["--dataset", "sr25", "--conv", "PPGN"], "item 10)"),
    (["--dataset", "count", "--dense", "--conv", "NGNN"], "item 10)"),
    (["--dataset", "count", "--norm", "ln"], "item 6)"),
    (["--dataset", "count", "--dense", "--conv", "I2GNN"], "drop --dense"),
])
def test_expressivity_gpu_refuses_what_the_port_lacks(argv, why, capsys):
    """The classification datasets and the dense mode exit through
    ``parser.error`` (code 2) with the ``ROADMAP.md`` item that ports
    them, before anything runs; dense I2GNN with the JAX script's own
    refusal."""
    with pytest.raises(SystemExit) as err:
        expressivity_gpu.parse_args(["--cpu", *argv])
    assert err.value.code == 2
    assert why in capsys.readouterr().err
