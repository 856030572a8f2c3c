"""The port's reference-checkpoint import and export
(``cgat_tpu_torch/tools/import_torch.py``) against cgat_tpu's, on the CPU.

The reference ``.ckpt`` is made here from tests/test_import_torch.py's
module tree with the reference's ``state_dict`` keys (``RefCGAtNet``,
``HP``; the reference's source is not needed). Both packages import it:
the port's weights must be cgat_tpu's, converted by
``state_dict_from_jax``, bit for bit, with the same normalisation and
model config; both imported models' f32 forwards agree at
tests/test_torch_model.py's tolerance (rtol 2e-4, atol 1e-5). Both exports give the same ``.ckpt``, and the port's export
then import is exact. An imported run loads through ``load_trainer``,
``cli.evaluate``, ``cli.predict`` and ``--pretrained-model``.
"""
import dataclasses
import gzip
import json
import pickle

import numpy as np
import jax
import pytest
import torch
from test_import_torch import HP, RefCGAtNet

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.tools import import_torch as jimport
from cgat_tpu.training.trainer import CheckpointManager as JCheckpoints
from cgat_tpu_torch.cli import evaluate as cli_evaluate
from cgat_tpu_torch.cli import predict as cli_predict
from cgat_tpu_torch.cli import prepare as cli_prepare
from cgat_tpu_torch.cli import train as cli_train
from cgat_tpu_torch.data import collate
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGAtNet, state_dict_from_jax
from cgat_tpu_torch.tools import import_torch
from cgat_tpu_torch.training import CheckpointManager, load_trainer

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (tiny ops beside the other test
    processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_state_dict():
    torch.manual_seed(0)
    ref = RefCGAtNet(200, 8, 2, 128, 2, 2)
    return {**{f"model.{k}": v for k, v in ref.state_dict().items()},
            "mean": torch.tensor([0.25]), "std": torch.tensor([2.0])}


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The reference .ckpt, and its import by each package."""
    tmp = tmp_path_factory.mktemp("import")
    path = tmp / "ref.ckpt"
    torch.save({"state_dict": _ref_state_dict(), "hyper_parameters": HP,
                "epoch": 7, "global_step": 123}, path)
    return {"tmp": tmp, "ckpt": str(path),
            "jax": jimport.import_checkpoint(str(path), str(tmp / "jax")),
            "port": import_torch.import_checkpoint(str(path),
                                                   str(tmp / "port"))}


def _port_run(run):
    return CheckpointManager.load(run, map_location="cpu")


def test_import_equals_cgat_tpus(imported):
    params, jmeta = JCheckpoints.load(imported["jax"])
    sd, meta = _port_run(imported["port"])
    cfg = import_torch.config_from_hparams(HP)
    want = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert list(sd) == list(CGAtNet(cfg).state_dict())
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], v), k
    assert (meta["mean"], meta["std"]) == (jmeta["mean"], jmeta["std"]) \
        == (0.25, 2.0)
    assert meta["model_config"] == jmeta["model_config"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jimport.config_from_hparams(HP))
    for k in ("epoch", "imported_from"):
        assert meta[k] == jmeta[k]
    for k in ("target", "max_nbr", "batch_size", "learning_rate", "optim"):
        assert meta["trainer_config"][k] == jmeta["trainer_config"][k] \
            == HP[k]
    payload = torch.load(f"{imported['port']}/checkpoints/best.pt",
                         weights_only=True)
    assert sorted(payload) == ["model", "step"] and payload["step"] == 123


def test_config_from_an_argparse_namespace():
    import argparse

    assert import_torch.config_from_hparams(argparse.Namespace(**HP)) == \
        import_torch.config_from_hparams(HP)


def test_imported_forward_matches_cgat_tpus(imported):
    params, _ = JCheckpoints.load(imported["jax"])
    trainer, _ = load_trainer(imported["port"], device="cpu")
    cfg = trainer.model_cfg
    kw = dict(n_atoms_range=(3, 6), max_nbr=4, orig_fea=200)
    jbatch = jcollate(jrandom_graphs(0, 4, **kw), max_nbr=4, node_bucket=8)
    batch = collate(random_graphs(0, 4, **kw), max_nbr=4, node_bucket=8)
    want = np.asarray(JNet(jimport.config_from_hparams(HP)).apply(
        {"params": jax.tree.map(jax.numpy.asarray, params)}, jbatch))
    with torch.no_grad():
        got = trainer.model.eval()(batch).numpy()
    assert cfg.compute_dtype == "float32" and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_export_equals_cgat_tpus(imported):
    tmp = imported["tmp"]
    jimport.export_checkpoint(imported["jax"], str(tmp / "jax.ckpt"))
    import_torch.export_checkpoint(imported["port"], str(tmp / "port.ckpt"))
    want = torch.load(tmp / "jax.ckpt", weights_only=False)
    got = torch.load(tmp / "port.ckpt", weights_only=False)
    assert sorted(got) == sorted(want)
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got["state_dict"][k], v), k
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert got["hyper_parameters"]["mean_pooling"] is HP["mean_pooling"]
    assert (got["epoch"], got["global_step"]) == (want["epoch"],
                                                  want["global_step"])
    # the export is the reference checkpoint's tensors, bit for bit
    ref = _ref_state_dict()
    assert sorted(got["state_dict"]) == sorted(ref)
    assert all(torch.equal(got["state_dict"][k], v) for k, v in ref.items())


def test_export_then_import_is_exact(imported):
    tmp = imported["tmp"]
    back = import_torch.main([imported["port"], "--export", "--out",
                              str(tmp / "round.ckpt")])
    assert back == 0
    assert import_torch.main([str(tmp / "round.ckpt"), "--out",
                              str(tmp / "again")]) == 0
    sd1, m1 = _port_run(imported["port"])
    sd2, m2 = _port_run(str(tmp / "again"))
    assert list(sd1) == list(sd2)
    assert all(torch.equal(v, sd2[k]) for k, v in sd1.items())
    assert (m1["mean"], m1["std"], m1["model_config"]) == \
        (m2["mean"], m2["std"], m2["model_config"])


def test_refusals_and_strictness(imported, tmp_path):
    cfg = import_torch.config_from_hparams(HP)
    node_only = dataclasses.replace(cfg, update_edges=False)
    with pytest.raises(ValueError, match="update_edges=False"):
        import_torch.state_dict_from_reference(_ref_state_dict(), node_only)
    stray = {**_ref_state_dict(),
             "model.graphs.0.Node.stray.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match="unconsumed"):
        import_torch.state_dict_from_reference(stray, cfg)
    missing = _ref_state_dict()
    missing.pop("model.output_nn.fc_out.bias")
    with pytest.raises(KeyError):
        import_torch.state_dict_from_reference(missing, cfg)
    wrong = _ref_state_dict()
    wrong["model.embedding.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        import_torch.state_dict_from_reference(wrong, cfg)
    # a node-only run is not exported
    run = tmp_path / "node_only"
    (run / "checkpoints").mkdir(parents=True)
    sd, meta = _port_run(imported["port"])
    torch.save({"model": sd, "step": 0}, run / "checkpoints" / "best.pt")
    meta["model_config"]["update_edges"] = False
    (run / "checkpoints" / "best.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="update_edges=False"):
        import_torch.export_checkpoint(str(run), str(tmp_path / "x.ckpt"))


def test_imported_run_loads_through_the_clis(imported, tmp_path):
    with gzip.open(tmp_path / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 24), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(tmp_path), "--target-dir", str(tmp_path),
                             "--target-file", "p.pickle.gz", "--max-nbr",
                             "4"]) == 0
    data = str(tmp_path / "p.pickle.gz")
    run = imported["port"]
    assert cli_evaluate.main([run, "--data-path", data,
                              "--device", "cpu"]) == 0
    out = tmp_path / "pred.pickle.gz"
    assert cli_predict.main([run, data, "--out", str(out), "--target",
                             "e_above_hull", "--device", "cpu"]) == 0
    with gzip.open(out, "rb") as f:
        pred = pickle.load(f)["pred"]
    assert pred.shape == (24,) and np.isfinite(pred).all()
    assert cli_train.main(["--pretrained-model", run, "--data-path", data,
                           "--target", "e_above_hull", "--max-nbr", "4",
                           "--batch-size", "4", "--smoke-test",
                           "--node-bucket", "8", "--ckpt-dir",
                           str(tmp_path / "logs"), "--run-name", "tuned",
                           "--device", "cpu"]) == 0
    tuned, _ = load_trainer(str(tmp_path / "logs" / "runs" / "tuned"),
                            device="cpu")
    assert tuned.model_cfg == load_trainer(run, device="cpu")[0].model_cfg
