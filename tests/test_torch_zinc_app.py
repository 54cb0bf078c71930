"""The ZINC training entry point of the port and the modules it brings,
against the JAX package, on the CPU: ``load_zinc`` on the fixture,
``ParallelPreprocessDataset`` and its cache, ``padding_stats``, the growth
events of ``Buckets``, ``MetricsLogger``, ``device_memory_stats``, the
checkpoints (resumed training against uninterrupted training), and
``example/zinc_gpu.py`` at a small size, with each option the port lacks
refused.

Everything here is host code that both packages run the same way, so
every comparison is exact: the same graphs, datas, reports and records
bit for bit, and resumed training bit for bit equal to training that was
never stopped.  Every input comes from a numpy seed."""

import io
import json
import os
import pickle
import subprocess
import sys
from contextlib import redirect_stdout
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from pygho_tpu.hodata import datasets as jx_datasets
from pygho_tpu.hodata import loader as jx_loader
from pygho_tpu.hodata import preprocess as jx_preprocess
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.utils import device_memory_stats as jx_device_memory_stats
from pygho_tpu.utils.metrics import MetricsLogger as JxMetricsLogger

from pygho_tpu_torch.hodata import (Buckets, KhopSampler,
                                    ParallelPreprocessDataset, SpDataloader,
                                    Sppretransform, load_zinc, padding_stats,
                                    synthetic_zinc)
from pygho_tpu_torch.hodata import preprocess as pt_preprocess
from pygho_tpu_torch.models import (cosine_warm_restarts, make_optimizer,
                                    make_sp_model, make_sparse_steps)
from pygho_tpu_torch.utils import (MetricsLogger, device_memory_stats,
                                   restore_checkpoint, save_checkpoint)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "zinc"
KEY = "X___X___1___A___0"
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}

sys.path.insert(0, str(REPO / "example"))
import zinc_gpu  # noqa: E402


def _same(a, b):
    """Identical keys, dtypes, shapes and values, recursively."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _transforms(hop=2):
    """The JAX and the port's sparse pre-transforms of the same sampler
    and key."""
    return (jx_loader.Sppretransform(partial(JxKhopSampler, hop=hop), [""],
                                     [KEY]),
            Sppretransform(partial(KhopSampler, hop=hop), [""], [KEY]))


@pytest.mark.parametrize("subset", [True, False])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_zinc_matches_jax(split, subset):
    """``load_zinc`` on the fixture's raw files, from the root and from
    ``raw/`` itself: the JAX package's graphs, field for field."""
    want = jx_datasets.load_zinc(str(FIXTURE), split, subset=subset)
    for root in (FIXTURE, FIXTURE / "raw"):
        got = load_zinc(str(root), split, subset=subset)
        assert len(got) == len(want) > 0
        for gp, gj in zip(got, want):
            for f in ("x", "edge_index", "edge_attr", "y"):
                _same(getattr(gp, f), getattr(gj, f))
            assert gp.num_nodes == gj.num_nodes


def test_load_zinc_refuses_missing_and_malformed(tmp_path):
    """A missing split raises FileNotFoundError; a molecule without the
    expected keys raises KeyError naming it."""
    with pytest.raises(FileNotFoundError, match="raw"):
        load_zinc(str(tmp_path), "train")
    raw = tmp_path / "raw"
    raw.mkdir()
    with open(raw / "train.pickle", "wb") as f:
        pickle.dump([{"atom_type": np.zeros(2)}], f)
    with pytest.raises(KeyError, match="molecule 0"):
        load_zinc(str(tmp_path), "train")


def test_preprocess_dataset_matches_jax_and_caches(tmp_path):
    """``ParallelPreprocessDataset``: the JAX class's datas, bit for bit;
    a second construction loads the cache and gives the same datas; a
    process pool of two gives the same datas as the serial path."""
    jx_pre, pt_pre = _transforms()
    graphs = synthetic_zinc("val", n_graphs=12)
    jx = jx_preprocess.ParallelPreprocessDataset(
        str(tmp_path / "jx"), jx_datasets.synthetic_zinc("val", n_graphs=12),
        jx_pre, 0)
    first = ParallelPreprocessDataset(str(tmp_path / "pt"), graphs, pt_pre)
    assert not first.cache_hit and os.path.exists(first.cache_path)
    assert len(first) == len(jx) == 12
    for a, b in zip(first.datas, jx.datas):
        _same(a, b)
    again = ParallelPreprocessDataset(str(tmp_path / "pt"), [], pt_pre)
    assert again.cache_hit and len(again) == 12
    for a, b in zip(again.datas, first.datas):
        _same(a, b)
    pooled = ParallelPreprocessDataset(str(tmp_path / "pool"), graphs,
                                       pt_pre, num_worker=2)
    assert not pooled.cache_hit
    for a, b in zip(pooled.datas, first.datas):
        _same(a, b)


def test_preprocess_cache_is_never_shared_across_packages(tmp_path):
    """In one directory the JAX class and the port's write different
    files, and neither loads the other's; the port's fingerprint names
    its package and is the same in another process (so the cache is found
    again), and another hop gives another fingerprint."""
    jx_pre, pt_pre = _transforms()
    root = str(tmp_path / "shared")
    jx = jx_preprocess.ParallelPreprocessDataset(
        root, jx_datasets.synthetic_zinc("val", n_graphs=4), jx_pre, 0)
    pt = ParallelPreprocessDataset(root, synthetic_zinc("val", n_graphs=4),
                                   pt_pre)
    assert not pt.cache_hit and pt.cache_path != jx.cache_path
    assert sorted(os.listdir(root)) == sorted(
        os.path.basename(p) for p in (jx.cache_path, pt.cache_path))
    jx_again = jx_preprocess.ParallelPreprocessDataset(root, [], jx_pre, 0)
    assert jx_again.cache_path == jx.cache_path
    fp = pt_preprocess.transform_fingerprint(pt_pre)
    assert fp != jx_preprocess._transform_fingerprint(jx_pre)
    assert fp != pt_preprocess.transform_fingerprint(_transforms(3)[1])
    assert pt_preprocess._describe(pt_pre).count("pygho_tpu_torch.") >= 2
    code = ("from functools import partial; "
            "from pygho_tpu_torch.hodata import KhopSampler, Sppretransform;"
            " from pygho_tpu_torch.hodata.preprocess import "
            "transform_fingerprint as f; "
            f"print(f(Sppretransform(partial(KhopSampler, hop=2), [''], "
            f"['{KEY}'])))")
    other = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, check=True, cwd=REPO,
                           timeout=300).stdout.strip()
    assert other == fp


def test_padding_stats_matches_jax():
    """``padding_stats`` on one collated batch (the JAX collation, padded
    triples kept) equals JAX's report; on the port loader's batch of the
    same graphs the nodes, edges and tuples report the same, and the
    triples, stripped of their padding, no waste."""
    jx_pre, pt_pre = _transforms()
    gs = synthetic_zinc("val", n_graphs=16)
    jx_datas = [jx_pre(g) for g in jx_datasets.synthetic_zinc("val",
                                                              n_graphs=16)]
    batch = jx_collate_sparse(jx_datas, [KEY], num_graphs=16)
    want = jx_loader.padding_stats(batch)
    assert padding_stats(batch) == want
    assert want[f"{KEY}___acd"]["waste"] > 0
    mine = padding_stats(SpDataloader([pt_pre(g) for g in gs], 16,
                                      [KEY])._collate([pt_pre(g)
                                                       for g in gs]))
    for name in ("nodes", "edges", "tuples"):
        assert mine[name] == want[name]
    acd = mine[f"{KEY}___acd"]
    assert acd["real"] == acd["padded"] == want[f"{KEY}___acd"]["real"]
    assert acd["waste"] == 0.0


def test_buckets_record_growth_events_as_jax():
    """``Buckets`` keep the largest size of each key and record each
    growth as ``(key, old, new)``, the JAX registry's events for the same
    sets; ``drain_events`` returns and clears them."""
    sets = [("nodes", 64), ("nodes", 32), ("edges", 128), ("nodes", 96),
            ("edges", 128), ("tuples", 512)]
    mine, ref = Buckets(), jx_loader.Buckets()
    for k, v in sets:
        mine[k] = v
        ref[k] = v
    assert dict(mine) == dict(ref) == {"nodes": 96, "edges": 128,
                                       "tuples": 512}
    assert mine.events == ref.events
    assert mine.drain_events() == ref.drain_events() == [
        ("nodes", 0, 64), ("edges", 0, 128), ("nodes", 64, 96),
        ("tuples", 0, 512)]
    assert mine.drain_events() == [] and mine.events == []
    # a loader's buckets: the first epoch's growth, then none on a replay
    pre = _transforms()[1]
    dl = SpDataloader([pre(g) for g in synthetic_zinc("val", n_graphs=12)],
                      4, [KEY])
    list(dl)
    grown = dl.buckets.drain_events()
    assert {k for k, _, _ in grown} >= {"nodes", "edges", "tuples"}
    list(dl)
    assert dl.buckets.drain_events() == []


def test_metrics_logger_matches_jax(tmp_path):
    """``MetricsLogger``: the JAX logger's jsonl records (but the clock
    ``t``) and echoed epoch line for the same calls; no file without a
    path."""
    calls = [("log", ({"type": "padding", "nodes": {"real": 3}},)),
             ("log_epoch", (1, 1.5, 0.25, 2.0, 0.75, 0.5, 0.625)),
             ("log_epoch", (2, 1.25, 0.125, 2.0, 0.5, 0.25, 0.375, 1e-3)),
             ("log", ({"type": "telemetry", "epoch": 2,
                       "bucket_growth": [["nodes", 0, 64]]},))]
    records, echoed = [], []
    for cls, name in ((MetricsLogger, "pt"), (JxMetricsLogger, "jx")):
        path = tmp_path / name / f"{name}.jsonl"
        out = io.StringIO()
        with redirect_stdout(out):
            logger = cls(str(path))
            for fn, args in calls:
                getattr(logger, fn)(*args)
            logger.close()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert all(r.pop("t") >= 0 for r in recs)
        records.append(recs)
        echoed.append(out.getvalue())
    assert records[0] == records[1]
    assert echoed[0] == echoed[1]
    assert echoed[0].splitlines()[0] == (
        "epoch 1 trn time 1.50 val time 0.25 memory 2.00 GB  l1loss 0.7500 "
        "val MAE 0.5000 tst MAE 0.6250")
    silent = MetricsLogger(echo=False)
    silent.log_epoch(1, 0, 0, 0, 0, 0, 0)
    assert silent._fh is None


def test_device_memory_stats_is_empty_on_the_cpu():
    """No card: ``{}`` (JAX's CPU backend reports nothing either), also
    when the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the stats are the card's")
    assert device_memory_stats() == {} == jx_device_memory_stats()
    assert device_memory_stats("cpu") == {}


def _training(seed=0):
    """A 2x16 NGNN-SS on 48 synthetic graphs in batches of 16 (three a
    epoch), with the cosine schedule, so that a step depends on the
    optimizer's moments, its count and the BatchNorm statistics."""
    pre = _transforms()[1]
    datas = [pre(g) for g in synthetic_zinc("train", n_graphs=48)]
    model = make_sp_model("NGNN", num_layer=2, hiddim=16, mlp=MLPD,
                          seed=seed, device="cpu")
    opt = make_optimizer(model, cosine_warm_restarts(1e-2, 2, 3, 1e-4,
                                                     0.1, 0.01), 1e-3)
    loader = SpDataloader(datas, 16, [KEY], shuffle=True, drop_last=True,
                          backward=True)
    return model, opt, loader


def test_checkpoint_resume_equals_uninterrupted_training(tmp_path):
    """Three epochs straight, against one epoch, a checkpoint, a fresh
    model and optimizer (another seed) restored from it, and two more
    epochs on the same batches: the losses and every parameter and buffer
    bit for bit; ``restore_checkpoint`` returns the latest step."""
    train_step, _ = make_sparse_steps()

    def epoch(model, opt, batches):
        model.train()
        return [float(train_step(model, opt, b)) for b in batches]

    model, opt, loader = _training()
    batches = [list(loader) for _ in range(3)]
    straight = sum((epoch(model, opt, b) for b in batches), [])

    first, opt1, _ = _training()
    resumed = epoch(first, opt1, batches[0])
    save_checkpoint(str(tmp_path), first, opt1, step=0)   # an older one
    path = save_checkpoint(str(tmp_path), first, opt1, step=1)
    assert path == str(tmp_path / "step_1")
    fresh, opt2, _ = _training(seed=7)
    assert restore_checkpoint(str(tmp_path), fresh, opt2) == 1
    assert opt2.count == opt1.count == 3
    resumed += epoch(fresh, opt2, batches[1]) + epoch(fresh, opt2,
                                                      batches[2])
    assert resumed == straight
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k


def test_checkpoint_without_optimizer(tmp_path):
    """A model-only checkpoint restores the model and refuses to restore
    an optimizer; an empty directory raises."""
    model, opt, _ = _training()
    save_checkpoint(str(tmp_path), model, step=3)
    other, opt2, _ = _training(seed=5)
    assert restore_checkpoint(str(tmp_path), other, step=3) == 3
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 other.state_dict().values()))
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_checkpoint(str(tmp_path), other, opt2)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), other)


def _zinc_argv(tmp_path, *extra):
    return ["--cpu", "--num_layer", "2", "--hiddim", "32", "--epochs", "1",
            "--ntrain", "64", "--bs", "32", "--cache-dir",
            str(tmp_path / "cache"), "--log-dir", str(tmp_path / "logs"),
            "--converged-record", str(tmp_path / "rec.json"), *extra]


def test_zinc_gpu_cpu_run_writes_its_records(tmp_path):
    """``example/zinc_gpu.py --cpu --sparse --conv NGNN --fused`` at 2x32
    for one epoch on 64 graphs: the echoed epoch line, the jsonl records
    (padding, epoch, telemetry with ``bucket_growth``) under its own name,
    a finite MAE, a converged record with the keys of the JAX row, and the
    fast flag restored after the run."""
    from pygho_tpu_torch.kernels import get_fused_math

    out = io.StringIO()
    with redirect_stdout(out):
        scores = zinc_gpu.main(_zinc_argv(tmp_path, "--sparse", "--conv",
                                          "NGNN", "--fused", "--mlplayer",
                                          "2", "--outlayer", "4"))
    assert get_fused_math() is True
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert "epoch 1 trn time" in out.getvalue()
    log = tmp_path / "logs" / "zinc_gpu_sp_NGNN_h3_r0.jsonl"
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["type"] for r in recs] == ["padding", "epoch", "telemetry"]
    assert set(recs[1]) == {"t", "type", "epoch", "trn_time", "val_time",
                            "mem_gb", "trn_loss", "val_mae", "tst_mae", "lr"}
    assert set(recs[2]) == {"t", "type", "epoch", "bucket_growth"}
    assert recs[2]["bucket_growth"]          # the first epoch's buckets
    assert recs[0]["tuples"]["padded"] >= recs[0]["tuples"]["real"] > 0
    rec = json.loads((tmp_path / "rec.json").read_text())
    with open(REPO / "runs" / "converged" / "NGNN_sparse.s0.json") as f:
        want = json.load(f)
    assert set(rec) == set(want) and set(rec["hps"]) == set(want["hps"])
    assert rec["fused"] is True and rec["dataset"] == "SYNZINC"
    assert rec["ntrain"] == 64 and rec["best_val_epoch"] == 1
    assert rec["tst_mae_at_best_val"] == scores[0]


@pytest.mark.parametrize("argv", [["--conv", "PPGN"],
                                  ["--conv", "NGNN", "--bf16"],
                                  ["--sparse", "--conv", "NGAT"],
                                  ["--sparse", "--conv", "SSWL"],
                                  ["--sparse", "--conv", "DSSGNN",
                                   "--cpool", "sum"],
                                  ["--sparse", "--conv", "GNNAK"],
                                  ["--sparse", "--conv", "SUN", "--fused"],
                                  ["--sparse", "--conv", "PPGN"]])
def test_zinc_gpu_cpu_runs_each_ported_conv(tmp_path, argv):
    """Dense PPGN, dense NGNN with bf16 compute, and sparse NGAT, SSWL,
    DSSGNN (with ``--cpool sum``), GNNAK, SUN (in the fast mode) and PPGN,
    at 2x32 for one epoch: a finite test MAE, and the seed in the record
    name with ``--seed0 1``."""
    with redirect_stdout(io.StringIO()):
        scores = zinc_gpu.main(_zinc_argv(tmp_path, *argv, "--seed0", "1"))
    assert len(scores) == 1 and np.isfinite(scores[0])
    rec = json.loads((tmp_path / "rec.s1.json").read_text())
    assert rec["seed"] == 1 and rec["conv"] == argv[argv.index("--conv") + 1]


def test_zinc_gpu_reads_the_real_zinc_layout(tmp_path):
    """``--data-root`` on the fixture: the ZINC subset through
    ``load_zinc``, tagged ``ZINC``."""
    with redirect_stdout(io.StringIO()):
        zinc_gpu.main(_zinc_argv(tmp_path, "--sparse", "--data-root",
                                 str(FIXTURE), "--bs", "2"))
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["dataset"] == "ZINC"
    assert rec["tst_mae_at_best_val"] is not None
    assert any(d.startswith("ZINC_sp_NGNN_h3_")
               for d in os.listdir(tmp_path / "cache"))


@pytest.mark.parametrize("argv,item", [
    (["--sparse", "--conv", "I2GNN"], "item 7"),
    (["--conv", "GNNAK"], "item 9"),
    (["--conv", "SSWL"], "item 9"),
    (["--sparse", "--aggr", "mean"], "item 6"),
    (["--sparse", "--conv", "NGAT", "--aggr", "max"], "item 8"),
    (["--sparse", "--lpool", "max"], "item 6"),
    (["--sparse", "--conv", "SUN", "--cpool", "max"], "item 6"),
    (["--norm", "ln"], "item 6"),
    (["--dp", "0.1"], "item 6"),
    (["--sparse", "--remat"], "item 6"),
    (["--remat"], "item 9"),
    (["--sparse", "--ddp", "2"], "item 12"),
    (["--sparse", "--chained"], "item 4"),
    (["--sparse", "--fused", "--plan-measure"], "item 10"),
])
def test_zinc_gpu_refuses_what_the_port_lacks(argv, item, capsys):
    """Each option the port lacks exits through ``parser.error`` (code 2)
    with the ROADMAP.md item that ports it, before anything runs."""
    with pytest.raises(SystemExit) as err:
        zinc_gpu.parse_args(["--cpu", *argv])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "ROADMAP.md" in msg and f"{item})" in msg


@pytest.mark.parametrize("argv", [["--conv", "NGAT"], ["--conv", "I2GNN"]])
def test_zinc_gpu_refuses_as_the_jax_script(argv, capsys):
    """The JAX script's own refusals: NGAT and I2GNN are sparse-only."""
    with pytest.raises(SystemExit) as err:
        zinc_gpu.parse_args(["--cpu", *argv])
    assert err.value.code == 2 and "--sparse" in capsys.readouterr().err


def test_zinc_gpu_accepts_what_the_ported_convs_ignore():
    """As in JAX, the DD mode aggregates by sum whatever ``--aggr`` says,
    and ``--cpool`` reaches no ported dense conv: both parse."""
    args = zinc_gpu.parse_args(["--conv", "NGNN", "--aggr", "max",
                                "--cpool", "sum"])
    assert zinc_gpu.refusal(args) is None
    assert zinc_gpu.parse_args(["--sparse", "--conv", "NGAT", "--fused",
                                "--bf16"]).bf16


def test_zinc_gpu_ckpt_resumes_as_an_unbroken_run(tmp_path):
    """``zinc_gpu.py --sparse --conv SUN --fused --cpool sum --ckpt DIR``
    at 2x16 on 32 graphs: one epoch, then a second run of two epochs that
    resumes after the checkpoint of epoch 1, give the two epochs' losses,
    MAE and converged record of an unbroken two-epoch run bit for bit
    (all but the epoch times), keep only the latest checkpoint, and append
    to the same jsonl records; ``--cpool`` reaches SUN's cross-subgraph
    pooling."""
    base = ["--cpu", "--sparse", "--conv", "SUN", "--fused", "--cpool",
            "sum", "--num_layer", "2", "--hiddim", "16", "--ntrain", "32",
            "--bs", "16", "--mlplayer", "2", "--cache-dir",
            str(tmp_path / "cache")]

    def run(name, epochs, ckpt=None):
        argv = base + ["--epochs", str(epochs), "--log-dir",
                       str(tmp_path / name), "--converged-record",
                       str(tmp_path / f"{name}.json")]
        if ckpt:
            argv += ["--ckpt", str(tmp_path / ckpt)]
        models = []
        with redirect_stdout(io.StringIO()):
            rec = zinc_gpu.run_once(zinc_gpu.parse_args(argv), 0,
                                    lambda e, r: models.append(r.model))
        return rec, models

    whole, models = run("whole", 2)
    assert models[0].subggnns[0].pool2node.mod.pool == "sum"
    run("parts", 1, "ck")
    assert os.listdir(tmp_path / "ck" / "r0") == ["step_1"]
    resumed, models = run("parts", 2, "ck")
    assert len(models) == 1                    # epoch 2 alone ran
    assert os.listdir(tmp_path / "ck" / "r0") == ["step_2"]
    for rec in (whole, resumed):
        rec.pop("sec_per_epoch_median")
    assert resumed == whole

    def epochs(name):
        log = tmp_path / name / "zinc_gpu_sp_SUN_h3_r0.jsonl"
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        return [(r["epoch"], r["trn_loss"], r["val_mae"], r["tst_mae"])
                for r in recs if r["type"] == "epoch"], \
            [r["type"] for r in recs].count("padding")

    assert epochs("parts") == (epochs("whole")[0], 2)


def test_minimal_gpu_ckpt_saves_and_resumes(tmp_path):
    """``example/minimal_gpu.py --cpu --ckpt DIR``: a checkpoint a epoch
    under ``DIR/step_<epoch>``, and a second run resumes after the latest,
    as ``minimal_tpu.py --ckpt`` does."""
    cmd = [sys.executable, str(REPO / "example" / "minimal_gpu.py"), "--cpu",
           "--hiddim", "16", "--num_layer", "2", "--ckpt",
           str(tmp_path / "ck")]
    first = subprocess.run(cmd + ["--epochs", "1"], capture_output=True,
                           text=True, timeout=300, check=True, cwd=REPO)
    assert "resumed" not in first.stdout
    second = subprocess.run(cmd + ["--epochs", "2"], capture_output=True,
                            text=True, timeout=300, check=True, cwd=REPO)
    assert "resumed from epoch 1" in second.stdout
    epochs = [json.loads(line)["epoch"] for line in second.stdout.splitlines()
              if line.startswith("{")]
    assert epochs == [2]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_2"]
