"""The port's user path on the CPU: the anchor (the port's Trainer against
cgat_tpu's on the same prepared data, weights and schedule), the CLI flow
prepare -> train -> evaluate -> predict, exact resume, the moment-dtype
check on resume, and the CLI flags against cgat_tpu's."""
import argparse
import gzip
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from cgat_tpu.cli import common as jcommon
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.training import Trainer as JTrainer
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu_torch.cli import common
from cgat_tpu_torch.cli import evaluate as cli_evaluate
from cgat_tpu_torch.cli import predict as cli_predict
from cgat_tpu_torch.cli import prepare as cli_prepare
from cgat_tpu_torch.cli import train as cli_train
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.models import CGATConfig, state_dict_from_jax
from cgat_tpu_torch.training import (MetricsLogger, Trainer, TrainerConfig,
                                     load_trainer, resume_trainer)

torch.backends.cuda.matmul.allow_tf32 = False
# Start torch's CPU thread pool now: its first parallel kernel after JAX's
# CPU runtime has started can come out less exact (torch.exp off by ~1e-4
# relative, once), which the f32 comparisons below would see.
torch.exp(torch.zeros(1 << 20))

TINY = dict(elem_fea_len=16, n_graph=2, nbr_embedding_size=8,
            neighbor_number=6, msg_heads=2, n_graph_roost=1,
            out_hidden=(32, 32, 16))
# a tiny model through the CLI's flags (the output head keeps its default)
TINY_FLAGS = ["--max-nbr", "6", "--atom-fea-len", "8", "--n-graph", "1",
              "--nbr-embedding-size", "8", "--msg-heads", "2",
              "--n-graph-roost", "1", "--batch-size", "8",
              "--node-bucket", "8", "--target", "e_above_hull",
              "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here are thousands of small ops: with the test
    workers sharing the machine's cores, torch's parallel regions wait on
    descheduled threads far longer than they compute. One thread per test
    keeps them fast; the count is restored (and its pool started) after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.exp(torch.zeros(1 << 20))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """40 prototype crystals through the port's ``cli.prepare``."""
    d = tmp_path_factory.mktemp("data")
    with gzip.open(d / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 40), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(d), "--target-dir", str(d), "--target-file",
                             "prepared.pickle.gz", "--max-nbr", "6"]) == 0
    return d / "prepared.pickle.gz"


def _metrics(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_trainer_anchor_matches_cgat_tpu(prepared, tmp_path):
    """The round's main-path criterion at tiny dims: cgat_tpu's Trainer and
    the port's on the same prepared pickle (``data_path``), the same config
    and the same initial weights, 4 epochs validated each epoch under the
    plateau schedule (full learning rate from the first epoch). The split
    and normalisation are equal; each epoch's val_mae agrees to 1e-3
    relative, the evaluation tolerance of test_train_steps_match_cgat_tpu,
    while it falls by more than 1 % over the 4 epochs."""
    # one node bucket for every batch: cgat_tpu compiles each shape once
    train = dict(data_path=str(prepared), target="e_above_hull", max_nbr=6,
                 batch_size=4, node_bucket=64, num_comp_slots=8,
                 learning_rate=3e-3, check_val_every_n_epoch=1, epochs=4,
                 clr=False, run_name="anchor")
    jt = JTrainer(JTrainerConfig(**train, ckpt_dir=str(tmp_path / "jax")),
                  JConfig(**TINY))
    state = jt.init_state()
    cfg = CGATConfig(**TINY)
    t = Trainer(TrainerConfig(**train, ckpt_dir=str(tmp_path / "port")), cfg,
                device="cpu")
    assert [g.cry_id for g in t.train_graphs] == [
        g.cry_id for g in jt.train_graphs]
    assert [g.cry_id for g in t.val_graphs] == [g.cry_id
                                                for g in jt.val_graphs]
    assert [g.cry_id for g in t.test_graphs] == [
        g.cry_id for g in jt.test_graphs]
    assert (t.mean, t.std) == (jt.mean, jt.std)
    t.init_state(state_dict_from_jax(jax.tree.map(np.array, state.params),
                                     cfg))
    jt.fit(state)
    history = t.fit()
    runs = {k: tmp_path / k / "runs" / "anchor" for k in ("jax", "port")}
    val = {k: [m for m in _metrics(r) if "val_mae" in m]
           for k, r in runs.items()}
    assert [m["epoch"] for m in val["port"]] == [0, 1, 2, 3]
    assert [m["epoch"] for m in val["jax"]] == [0, 1, 2, 3]
    assert [m["step"] for m in val["port"]] == [m["step"] for m in val["jax"]]
    np.testing.assert_allclose([m["val_mae"] for m in val["port"]],
                               [m["val_mae"] for m in val["jax"]], rtol=1e-3)
    assert val["port"][-1]["val_mae"] < 0.99 * val["port"][0]["val_mae"]
    assert [h["val_mae"] for h in history] == [m["val_mae"]
                                               for m in val["port"]]
    best = {k: json.loads((r / "checkpoints" / "best.json").read_text())
            for k, r in runs.items()}
    assert best["port"].keys() == best["jax"].keys()
    assert best["port"]["epoch"] == best["jax"]["epoch"]
    assert (best["port"]["mean"], best["port"]["std"]) == (
        best["jax"]["mean"], best["jax"]["std"])
    np.testing.assert_allclose(best["port"]["best_val"],
                               best["jax"]["best_val"], rtol=1e-3)
    np.testing.assert_allclose(best["port"]["plateau"]["best"],
                               best["jax"]["plateau"]["best"], rtol=1e-3)
    train_keys = {k for m in _metrics(runs["jax"]) for k in m}
    assert {k for m in _metrics(runs["port"]) for k in m} == train_keys


def test_val_and_test_paths_equal_cgat_tpu(prepared):
    """With ``val_path`` and ``test_path`` the whole of ``data_path``
    trains and the other two load from their own paths, as in cgat_tpu."""
    kw = dict(data_path=str(prepared), val_path=str(prepared),
              test_path=str(prepared), target="e_form", max_nbr=6)
    jt = JTrainer(JTrainerConfig(**kw), JConfig(**TINY))
    t = Trainer(TrainerConfig(**kw), CGATConfig(**TINY), device="cpu")
    for split in ("train_graphs", "val_graphs", "test_graphs"):
        assert [g.cry_id for g in getattr(t, split)] == [
            g.cry_id for g in getattr(jt, split)]
        assert len(getattr(t, split)) == 40
    assert (t.mean, t.std) == (jt.mean, jt.std)


def test_cli_flow(prepared, tmp_path):
    """prepare -> train --smoke-test -> evaluate -> predict (and
    --embeddings), all on the CPU: exit codes, files and finite outputs."""
    logs = tmp_path / "logs"
    assert cli_train.main(["--data-path", str(prepared), "--smoke-test",
                           "--ckpt-dir", str(logs), "--run-name", "flow",
                           "--learning-rate", "1e-3", *TINY_FLAGS]) == 0
    run = logs / "runs" / "flow"
    for tag in ("best", "last"):
        assert (run / "checkpoints" / f"{tag}.pt").is_file()
        meta = json.loads((run / "checkpoints" / f"{tag}.json").read_text())
        assert set(meta) == {"epoch", "val_mae", "best_val", "plateau",
                             "mean", "std", "trainer_config", "model_config"}
        assert meta["epoch"] == 1 and np.isfinite(meta["val_mae"])
    metrics = _metrics(run)
    assert [m["epoch"] for m in metrics] == [0, 1, 1]
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert metrics[0]["graphs_per_sec"] > 0

    assert cli_evaluate.main([str(run), "--device", "cpu"]) == 0
    trainer, meta = load_trainer(str(run), train=True, device="cpu")
    test = trainer.evaluate_split(trainer.test_graphs)
    assert all(np.isfinite(v) for v in test.values())
    assert cli_evaluate.main([str(run), "--data-path", str(prepared),
                              "--device", "cpu"]) == 0

    out = tmp_path / "preds.pickle.gz"
    assert cli_predict.main([str(run), str(prepared), "--out", str(out),
                             "--device", "cpu"]) == 0
    with gzip.open(out, "rb") as f:
        preds = pickle.load(f)
    assert len(preds["pred"]) == len(preds["ids"]) == len(preds["target"])
    assert len(preds["ids"]) == 40 and np.isfinite(preds["pred"]).all()
    by_id = dict(zip(preds["ids"], preds["pred"]))
    np.testing.assert_allclose(
        [by_id[g.cry_id] for g in trainer.test_graphs],
        trainer.predict(trainer.test_graphs), rtol=1e-5, atol=1e-6)

    emb = tmp_path / "emb.pickle.gz"
    assert cli_predict.main([str(run), str(prepared), "--out", str(emb),
                             "--embeddings", "--device", "cpu"]) == 0
    with gzip.open(emb, "rb") as f:
        embs = pickle.load(f)
    assert embs["embeddings"].shape == (40, 8 * 2)
    assert embs["embeddings"].dtype == np.float32
    assert np.isfinite(embs["embeddings"]).all()

    # a full fine-tune from the checkpoint
    assert cli_train.main(["--data-path", str(prepared), "--smoke-test",
                           "--ckpt-dir", str(logs), "--run-name", "tuned",
                           "--pretrained-model", str(run),
                           *TINY_FLAGS]) == 0
    assert (logs / "runs" / "tuned" / "checkpoints" / "best.pt").is_file()


def test_resume_is_exact(prepared, tmp_path):
    """4 epochs straight, and 2 epochs then ``--ckp`` to 4, log the same
    metrics (validation on epochs 1 and 3, the CLI's default)."""
    flags = ["--data-path", str(prepared), "--learning-rate", "1e-3",
             "--ckpt-dir", str(tmp_path), *TINY_FLAGS]
    assert cli_train.main([*flags, "--run-name", "straight",
                           "--epochs", "4"]) == 0
    assert cli_train.main([*flags, "--run-name", "split",
                           "--epochs", "2"]) == 0
    run = tmp_path / "runs" / "split"
    assert cli_train.main(["--ckp", str(run), "--epochs", "4",
                           "--device", "cpu"]) == 0
    straight, split = (_metrics(tmp_path / "runs" / name)
                       for name in ("straight", "split"))
    assert [m["epoch"] for m in split] == [0, 1, 1, 2, 3, 3]
    assert [m["step"] for m in split] == [m["step"] for m in straight]
    for a, b in zip(split, straight, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            if k.startswith(("train_", "val_")):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    meta = json.loads((run / "checkpoints" / "last.json").read_text())
    assert meta["epoch"] == 3


def test_resume_with_another_moment_dtype_names_it(prepared, tmp_path):
    assert cli_train.main(["--data-path", str(prepared), "--smoke-test",
                           "--ckpt-dir", str(tmp_path), "--run-name", "r",
                           *TINY_FLAGS]) == 0
    run = str(tmp_path / "runs" / "r")
    with pytest.raises(ValueError, match="--moment-dtype bfloat16") as err:
        cli_train.main(["--ckp", run, "--epochs", "3", "--device", "cpu",
                        "--moment-dtype", "float32"])
    assert "float32" in str(err.value)


def _parsers():
    out = []
    for mod in (jcommon, common):
        p = argparse.ArgumentParser()
        mod.add_trainer_args(p)
        mod.add_model_args(p)
        out.append(p)
    common.add_device_arg(out[1])
    return out


@pytest.mark.parametrize("argv", [
    [],
    ["--gpus", "2", "--first-gpu", "0", "--distributed_backend", "ddp",
     "--amp_optimization", "01", "--workers", "4", "--train", "--test",
     "--mean-pooling", "--std-loss", "--update_edges", "--acc_batches", "3",
     "--lr", "2e-4"],
    ["--vector_attention", "--global_vector_attention", "--no-clr",
     "--robust-loss", "--precision", "float32", "--moment-dtype", "bfloat16"],
    ["--data-path", "d", "--fea-path", "f.json", "--target", "volume",
     "--val-path", "v", "--test-path", "t", "--ckp", "run",
     "--pretrained-model", "pre", "--tensorboard", "--last-ckpt-every", "3",
     "--smoke-test", "--seed", "5", "--num-comp-slots", "4"],
    ["--devices", "1", "--acc-batches", "2", "--edge-shards", "2",
     "--streaming", "--optim", "SGD", "--remat", "--hyper-edges",
     "--no-update-edges", "--steps-per-dispatch", "4", "--profile-epoch", "1",
     "--version", "mod", "--only-residual", "--no-rezero"],
])
def test_cli_flags_equal_cgat_tpu(argv):
    jp, p = _parsers()
    got = vars(p.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jp.parse_args(argv))


@pytest.mark.parametrize("argv,error,match", [
    (["--streaming"], ValueError, "streaming=True requires --val-path"),
    (["--profile-epoch", "1"], None, None),
])
def test_flags_not_ported_raise(argv, error, match, tmp_path, prepared):
    """No flag is left unported. ``--streaming`` without ``--val-path``
    raises cgat_tpu's ``ValueError`` before any data is read (the data
    path does not exist); ``--profile-epoch 1`` traces a smoke test's
    epoch 1: one trace under the run's ``profile`` directory, with that
    epoch's steps as ``train_step`` spans."""
    from cgat_tpu_torch.utils.profiling import trace_files, trace_kernels

    if error is not None:
        with pytest.raises(error, match=match):
            cli_train.main(["--data-path", str(tmp_path / "none"),
                            "--device", "cpu", *argv])
        return
    assert cli_train.main(["--data-path", str(prepared), *TINY_FLAGS,
                           "--smoke-test", "--ckpt-dir", str(tmp_path),
                           "--run-name", "p", *argv]) == 0
    run = tmp_path / "runs" / "p"
    steps = [m["step"] for m in _metrics(run) if "train_loss" in m]
    path, = trace_files(str(run / "profile"))
    assert len(steps) == 2
    assert trace_kernels(path)["span:train_step"][1] == steps[1] - steps[0]


def test_devices_zero_is_one_card_and_cuda_needs_a_card(prepared, capsys):
    _, p = _parsers()
    args = p.parse_args(["--devices", "0"])
    tcfg, _ = common.configs_from_args(args)
    # every visible card: one on a one-card machine, and one without a
    # card (where --device cuda then raises)
    assert tcfg.n_devices == max(torch.cuda.device_count(), 1)
    if not torch.cuda.is_available():
        for main, argv in ((cli_train.main, ["--data-path", str(prepared)]),
                           (cli_evaluate.main, ["run"]),
                           (cli_predict.main, ["run", str(prepared)])):
            with pytest.raises(RuntimeError, match="--device cpu"):
                main(argv)


def test_metrics_logger_warns_without_tensorboard(tmp_path, monkeypatch,
                                                  capsys):
    """TensorBoard asked for and not importable: a warning, and the JSONL
    log still written."""
    import builtins
    real_import = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.log(3, epoch=0, train_loss=np.float32(0.5))
    logger.close()
    assert "warning" in capsys.readouterr().err
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec.keys() == {"step", "time", "epoch", "train_loss"}
    assert (rec["step"], rec["train_loss"]) == (3, 0.5)


PLUGIN = """
from cgat_tpu_torch.models import CGAtNet as _Base


class CGAtNet(_Base):
    \"\"\"A model plug-in: the port's CGAtNet with its output halved.\"\"\"

    def head(self, crys_fea, *, last_layer=True):
        return super().head(crys_fea, last_layer=last_layer) * 0.5
"""


@pytest.mark.parametrize("argv,field,value", [
    (["--optim", "LAMB"], "optim", "LAMB"),
    (["--acc-batches", "2"], "acc_batches", 2),
    (["--only-residual"], "only_residual", True),
    (["--version", "cli_plugin_model"], "version", "cli_plugin_model"),
    (["--hyper-edges"], "no_hyper", False),
    (["--no-update-edges"], "update_edges", False),
    (["--update_edges"], "update_edges", False),
    (["--remat"], "remat", True),
    (["--steps-per-dispatch", "2"], "steps_per_dispatch", 2),
])
def test_ported_flags_reach_the_config_and_train(argv, field, value,
                                                 prepared, tmp_path,
                                                 monkeypatch):
    """Each flag of a trainer option or model variant sets its config field
    as cgat_tpu's CLI sets it, and a tiny CPU run with it trains,
    validates and checkpoints; the run's checkpoint rebuilds the same
    model class (the plug-in's under ``--version``)."""
    (tmp_path / "cli_plugin_model.py").write_text(PLUGIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    jp, p = _parsers()
    args, jargs = p.parse_args(argv), jp.parse_args(argv)
    tcfg, mcfg = common.configs_from_args(args)
    jcfgs = jcommon.configs_from_args(jargs)
    cfg = tcfg if hasattr(tcfg, field) else mcfg
    assert getattr(cfg, field) == value
    assert getattr(jcfgs[0 if cfg is tcfg else 1], field) == value
    assert tcfg.momentum == jcfgs[0].momentum
    assert cli_train.main(["--data-path", str(prepared), "--smoke-test",
                           "--ckpt-dir", str(tmp_path), "--run-name", "r",
                           *TINY_FLAGS, *argv]) == 0
    run = tmp_path / "runs" / "r"
    recs = _metrics(run)
    assert recs and all(np.isfinite(v) for r in recs for v in r.values())
    trainer, _ = load_trainer(str(run), device="cpu")
    assert getattr(trainer.cfg if cfg is tcfg else trainer.model_cfg,
                   field) == value
    assert type(trainer.model).__module__ == (
        "cli_plugin_model" if field == "version"
        else "cgat_tpu_torch.models.cgat")


def test_resume_is_exact_for_lamb_with_accumulation(prepared, tmp_path):
    """LAMB with 3 mini-steps an update, 4 steps an epoch: 3 epochs
    straight, and 2 then ``--ckp`` to 3, log the same metrics; the
    checkpoint is taken 2 mini-steps into an accumulation, which the
    resume continues (LAMB with 2 resumed at an odd step:
    ``tests/test_torch_training.py::test_dropout_masks_replay_on_resume``)."""
    flags = ["--data-path", str(prepared), "--learning-rate", "1e-3",
             "--ckpt-dir", str(tmp_path), "--optim", "LAMB",
             "--acc-batches", "3", *TINY_FLAGS]
    assert cli_train.main([*flags, "--run-name", "straight",
                           "--epochs", "3"]) == 0
    assert cli_train.main([*flags, "--run-name", "split",
                           "--epochs", "2"]) == 0
    run = tmp_path / "runs" / "split"
    trainer, _ = resume_trainer(str(run), device="cpu")
    assert trainer.opt.mini_step == 2 and trainer.step == 8
    assert trainer.opt.inner.count == 2
    assert cli_train.main(["--ckp", str(run), "--epochs", "3",
                           "--device", "cpu"]) == 0
    straight, split = (_metrics(tmp_path / "runs" / name)
                       for name in ("straight", "split"))
    assert [m["step"] for m in split] == [m["step"] for m in straight]
    for a, b in zip(split, straight, strict=True):
        for k in a:
            if k.startswith(("train_", "val_")):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
