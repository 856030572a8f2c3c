"""The port's seed ensembles and model soups
(``cgat_tpu_torch/tools/ensemble.py``) against cgat_tpu's, on the CPU.

``summarize`` must write cgat_tpu's ``ensemble.csv`` byte for byte on the
same member files and return the same dict. Two members from
``init_params_host`` seeds 0 and 1, each written in both packages'
checkpoint layouts (cgat_tpu's orbax tree, the port's ``best.pt`` of
``state_dict_from_jax``), must soup to the same weights bit for bit, with
the same normalisation and member list. Then ``train``, ``predict``,
``summarize`` and ``soup`` run end to end through ``main`` at tiny dims
with ``--device cpu``.
"""
import dataclasses
import filecmp
import gzip
import json
import os
import pickle

import numpy as np
import jax
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.tools import ensemble as jensemble
from cgat_tpu.training.trainer import CheckpointManager as JCheckpoints
from cgat_tpu_torch.cli import predict as cli_predict
from cgat_tpu_torch.cli import prepare as cli_prepare
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.models import CGATConfig, state_dict_from_jax
from cgat_tpu_torch.tools import ensemble
from cgat_tpu_torch.training import CheckpointManager

TINY = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(32, 32, 16))
# a tiny model through cli.train's flags (the output head keeps its
# default)
TINY_FLAGS = ["--max-nbr", "6", "--atom-fea-len", "8", "--n-graph", "1",
              "--nbr-embedding-size", "8", "--msg-heads", "2",
              "--n-graph-roost", "1", "--batch-size", "8",
              "--node-bucket", "8", "--target", "e_above_hull"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (tiny ops beside the other test
    processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _member_files(root):
    rng = np.random.default_rng(0)
    for name, seeds, target in (("a", (0, 1, 2), True), ("b", (3, 5), False),
                                ("c", (7,), True)):
        d = root / name
        d.mkdir(parents=True)
        for s in seeds:
            np.savetxt(d / f"{s}.txt", rng.standard_normal(6))
        if target:
            np.savetxt(d / "target.txt", rng.standard_normal(6))
    (root / "not_a_dir.txt").write_text("x")


def test_summarize_equals_cgat_tpus(tmp_path):
    for side in ("jax", "port"):
        _member_files(tmp_path / side)
    want = jensemble.summarize(str(tmp_path / "jax"))
    got = ensemble.summarize(str(tmp_path / "port"))
    assert got.keys() == want.keys() == {"a", "b", "c"}
    np.testing.assert_equal(got, want)
    for name in want:
        assert filecmp.cmp(tmp_path / "jax" / name / "ensemble.csv",
                           tmp_path / "port" / name / "ensemble.csv",
                           shallow=False), name


def _members(tmp_path):
    """Members f-0 and f-1 from init_params_host seeds 0 and 1 in both
    layouts under ``<root>/runs``, means and stds of their own."""
    import orbax.checkpoint as ocp

    jcfg, cfg = JConfig(**TINY), CGATConfig(**TINY)
    jbatch = jcollate(jrandom_graphs(0, 3, n_atoms_range=(3, 5), max_nbr=6,
                                     orig_fea=16), max_nbr=6, node_bucket=8)
    for seed in (0, 1):
        params = init_params_host(JNet(jcfg), jbatch, seed=seed)
        meta = {"epoch": 3, "val_mae": 0.5, "best_val": 0.5, "plateau": None,
                "mean": 0.1 + seed, "std": 1.0 + 0.3 * seed,
                "trainer_config": {"seed": seed},
                "model_config": dataclasses.asdict(jcfg)}
        name = ensemble.member_run_name("ens_", seed)
        jdir = tmp_path / "jax" / "runs" / name / "checkpoints"
        jdir.mkdir(parents=True)
        with ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(str(jdir / "best"),
                       {"params": params, "step": np.int32(5),
                        "opt_state": {}})
        pdir = tmp_path / "port" / "runs" / name / "checkpoints"
        pdir.mkdir(parents=True)
        torch.save({"model": state_dict_from_jax(params, cfg), "step": 5},
                   pdir / "best.pt")
        for d in (jdir, pdir):
            (d / "best.json").write_text(json.dumps(meta))
    return cfg


def test_soup_equals_cgat_tpus(tmp_path):
    cfg = _members(tmp_path)
    jensemble.soup(str(tmp_path / "jax"), str(tmp_path / "jax_soup"))
    out = ensemble.soup(str(tmp_path / "port"), str(tmp_path / "port_soup"))
    assert out == str(tmp_path / "port_soup")
    params, jmeta = JCheckpoints.load(str(tmp_path / "jax_soup"))
    sd, meta = CheckpointManager.load(out, map_location="cpu")
    want = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v), k
    assert meta == jmeta
    assert meta["soup_members"] == ["ens_f-0", "ens_f-1"]
    assert (meta["mean"], meta["std"]) == pytest.approx((0.6, 1.15))
    payload = torch.load(os.path.join(out, "checkpoints", "best.pt"),
                         weights_only=True)
    assert sorted(payload) == ["model", "step"]


def test_soup_refuses_one_member_or_two_configs(tmp_path):
    _members(tmp_path)
    with pytest.raises(ValueError, match="need >=2 members"):
        ensemble.soup(str(tmp_path / "port"), str(tmp_path / "s"),
                      run_prefix="none_")
    meta_path = (tmp_path / "port" / "runs" / "ens_f-1" / "checkpoints"
                 / "best.json")
    meta = json.loads(meta_path.read_text())
    meta["model_config"]["msg_heads"] = 4
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="different model configs"):
        ensemble.soup(str(tmp_path / "port"), str(tmp_path / "s"))


def test_ensemble_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    with gzip.open(tmp_path / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 32), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(tmp_path), "--target-dir", str(tmp_path),
                             "--target-file", "p.pickle.gz", "--max-nbr",
                             "6"]) == 0
    data = str(tmp_path / "p.pickle.gz")
    logs = str(tmp_path / "logs")
    assert ensemble.main(["train", "--seeds", "0", "1", "--ckpt-dir", logs,
                          "--device", "cpu", "--", "--data-path", data,
                          "--smoke-test", *TINY_FLAGS]) == 0
    assert [os.path.basename(m) for m in ensemble.find_members(logs)] == [
        "ens_f-0", "ens_f-1"]
    out = str(tmp_path / "ens")
    assert ensemble.main(["predict", "--ckpt-dir", logs, "--out-dir", out,
                          "--data", data, "--device", "cpu"]) == 0
    d, = [os.path.join(out, n) for n in os.listdir(out)]
    assert sorted(os.listdir(d)) == ["0.txt", "1.txt", "target.txt"]
    capsys.readouterr()
    assert ensemble.main(["summarize", "--out-dir", out]) == 0
    printed = capsys.readouterr().out
    cols = np.loadtxt(os.path.join(d, "ensemble.csv"), delimiter=",",
                      skiprows=1)
    assert cols.shape == (32, 3) and np.isfinite(cols).all()
    assert (cols[:, 1] > 0).all()
    assert str(ensemble.summarize(out)) in printed
    soup_run = os.path.join(logs, "runs", "soup")
    assert ensemble.main(["soup", "--ckpt-dir", logs, "--out-run",
                          soup_run]) == 0
    pred = str(tmp_path / "soup.pickle.gz")
    assert cli_predict.main([soup_run, data, "--out", pred,
                             "--device", "cpu"]) == 0
    with gzip.open(pred, "rb") as f:
        p = pickle.load(f)["pred"]
    assert p.shape == (32,) and np.isfinite(p).all()
