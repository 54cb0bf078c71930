"""``example/zinc_gpu.py`` with the subgraph convs in dense mode, on the
CPU: one epoch of SSWL, DSSGNN, GNNAK and SUN (DD, 2 layers x 32, 32
synthetic training graphs), with ``--cpool`` reaching the cross-subgraph
pooling of DSSGNN, GNNAK and SUN, and ``--remat``, which checkpoints each
layer and gives the run of the same flags without it bit for bit.  The
models under them: ``tests/test_torch_dense_subgraph_models.py``.
"""

import io
import json
import math
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from pygho_tpu_torch.models import MaModel
from test_torch_dense_subgraph_models import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "example"))
import zinc_gpu  # noqa: E402

# the module holding each conv's cross-subgraph pooling
CPOOL_OF = {"DSSGNN": "pool2global", "GNNAK": "pool2node",
            "SUN": "pool2node"}


def _run(tmp_path, name, flags):
    """One epoch of ``zinc_gpu.py --cpu`` at 2 x 32 on 32 graphs; its
    converged record and the model after the epoch."""
    argv = ["--cpu", "--num_layer", "2", "--hiddim", "32", "--ntrain", "32",
            "--bs", "16", "--mlplayer", "2", "--outlayer", "4", "--hop", "4",
            "--epochs", "1", "--cache-dir", str(tmp_path / "cache"),
            "--log-dir", str(tmp_path / name), "--converged-record",
            str(tmp_path / f"{name}.json"), *flags]
    models = []
    with redirect_stdout(io.StringIO()):
        rec = zinc_gpu.run_once(zinc_gpu.parse_args(argv), 0,
                                lambda e, r: models.append(r.model))
    return rec, models[-1]


@pytest.mark.parametrize("conv", ["SSWL", "DSSGNN", "GNNAK", "SUN"])
def test_zinc_gpu_trains_dense_subgraph_conv(tmp_path, conv):
    """``zinc_gpu.py --cpu --conv CONV --cpool sum`` (dense, DD): one
    epoch gives a finite loss and finite val and test MAE in its converged
    record, the epoch's jsonl records, and a ``MaModel`` of that conv in
    DD mode whose cross-subgraph pooling (DSSGNN, GNNAK, SUN) is the
    ``--cpool`` sum."""
    rec, model = _run(tmp_path, conv, ["--conv", conv, "--cpool", "sum"])
    assert isinstance(model, MaModel) and not model.remat
    layer = model.subggnns[0]
    assert type(layer).__name__ == f"{conv}Conv"
    if conv in CPOOL_OF:
        assert getattr(layer, CPOOL_OF[conv]).mod.pool == "sum"
    assert rec["mode"] == "dense" and rec["conv"] == conv
    for key in ("best_val_mae", "tst_mae_at_best_val"):
        assert math.isfinite(rec[key]), key
    lines = [json.loads(x) for x in (tmp_path / conv).glob("*.jsonl")
             .__next__().read_text().splitlines()]
    epochs = [x for x in lines if x.get("type") == "epoch"]
    assert len(epochs) == 1 and math.isfinite(epochs[0]["trn_loss"])


def test_zinc_gpu_dense_remat_repeats_the_plain_run(tmp_path):
    """``zinc_gpu.py --cpu --conv SSWL --remat``: the model checkpoints its
    layers, and one epoch's loss and MAE equal those of the run without
    ``--remat`` bit for bit (the recompute repeats the same operations;
    the norms' running statistics move once)."""
    flags = ["--conv", "SSWL"]
    plain, pm = _run(tmp_path, "plain", flags)
    remat, rm = _run(tmp_path, "remat", flags + ["--remat"])
    assert rm.remat and not pm.remat
    for rec in (plain, remat):
        rec.pop("sec_per_epoch_median")
        rec.pop("remat", None)
    assert plain == remat
    sp, sr = pm.state_dict(), rm.state_dict()
    assert all((sp[k] == sr[k]).all() for k in sp)
