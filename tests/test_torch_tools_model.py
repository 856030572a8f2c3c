"""The port's tools that read a model (``cgat_tpu_torch/tools``: errors,
embeddings, analysis, tsne, loop) against ``cgat_tpu.tools``, on the CPU,
from the same weights: one cgat_tpu run (saved by its own orbax
``CheckpointManager``) and one port run with its weights converted
(``state_dict_from_jax``) and the same normalisation, at
tests/test_tools.py's tiny dims. Model outputs are held at the port's f32
forward tolerance (rtol 2e-4, atol 1e-5, as tests/test_torch_model.py),
scaled to each output's size; ids, their order and the pool surgery must
be equal. Then the port's active-learning round runs end to end on the
CPU with cgat_tpu's counts, and its exact t-SNE is held against
scikit-learn's affinities and cgat_tpu's ``tsne_embed``.
"""
import csv
import gzip
import os
import pickle
import shutil

import numpy as np
import jax
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.manifold import _t_sne, trustworthiness
from sklearn.metrics import pairwise_distances

from cgat_tpu.data.dataset import load_prepared as jload_prepared
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.tools import analysis as janalysis
from cgat_tpu.tools import embeddings as jembeddings
from cgat_tpu.tools import errors as jerrors
from cgat_tpu.tools import loop as jloop
from cgat_tpu.tools import shards as jshards
from cgat_tpu.training import Trainer as JTrainer
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu.training.trainer import CheckpointManager as JCheckpoints
from cgat_tpu.uncertainty.gp import fit_gp as jfit_gp
from cgat_tpu_torch.data.dataset import load_prepared
from cgat_tpu_torch.data.featurizer import build_dataset_prepare
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.models import CGATConfig, state_dict_from_jax
from cgat_tpu_torch.tools import analysis, embeddings, errors, loop, shards
from cgat_tpu_torch.tools import tsne as tsne_cli
from cgat_tpu_torch.training import (CheckpointManager, Trainer,
                                     TrainerConfig)
from cgat_tpu_torch.uncertainty import gp as port_gp

RTOL, ATOL = 2e-4, 1e-5
TINY = dict(orig_elem_fea_len=200, elem_fea_len=8, n_graph=1,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(8,))
TRAIN = dict(batch_size=4, epochs=2, node_bucket=16, max_nbr=6,
             target="e_above_hull", val_size=0.25, test_size=0.25)
N_SHARD = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (tiny ops beside the other test
    processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prepared(seed: int, n: int, offset: int) -> dict:
    entries = random_structures(seed, n)
    for i, e in enumerate(entries):
        e["data"]["id"] = f"{offset + i},1"
    return build_dataset_prepare(entries, max_neighbor_number=6,
                                 progress=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A two-shard pool, a sample, and the cgat_tpu and port runs of the
    same weights and normalisation trained on nothing (a fresh state,
    checkpointed as ``best``)."""
    tmp = tmp_path_factory.mktemp("tools_model")
    pool = str(tmp / "pool")
    for s in range(2):
        shards.save_pickle(_prepared(s, N_SHARD, s * N_SHARD),
                           shards.shard_path(s, pool))
    sample_path = str(tmp / "sample.pickle.gz")
    shards.save_pickle(_prepared(7, 12, 100), sample_path)
    jt = JTrainer(JTrainerConfig(**TRAIN, ckpt_dir=str(tmp), run_name="jax"),
                  JConfig(**TINY), jload_prepared(
                      sample_path, max_neighbor_number=6,
                      target="e_above_hull"))
    state = jt.init_state()
    jrun = os.path.join(str(tmp), "runs", "jax")
    JCheckpoints(jrun).save(state, jt, epoch=1, val_mae=1.0)
    cfg = CGATConfig(**TINY)
    t = Trainer(TrainerConfig(**TRAIN, ckpt_dir=str(tmp), run_name="port"),
                cfg, load_prepared(sample_path, max_neighbor_number=6,
                                   target="e_above_hull"), device="cpu")
    assert (t.mean, t.std) == (jt.mean, jt.std)
    t.init_state(state_dict_from_jax(
        jax.tree.map(np.asarray, state.params), cfg))
    prun = os.path.join(str(tmp), "runs", "port")
    CheckpointManager(prun).save(t, epoch=1, val_mae=1.0)
    return {"tmp": tmp, "pool": pool, "sample": sample_path, "jax": jrun,
            "port": prun, "jt": jt, "params": state.params}


def _copy_pool(runs, name):
    dst = str(runs["tmp"] / name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(runs["pool"], dst)
    return dst


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_scores(got_pool, want_pool):
    for i in range(2):
        gh, got = _read_csv(errors.error_csv_path(i, got_pool))
        wh, want = _read_csv(jerrors.error_csv_path(i, want_pool))
        assert gh == wh == ["batch_ids", "errors"]
        assert [r[0] for r in got] == [r[0] for r in want]
        assert len(got) == N_SHARD
        g = np.asarray([float(r[1]) for r in got])
        w = np.asarray([float(r[1]) for r in want])
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())


def _jax_gp_pickle(runs, path):
    """A GP fitted by cgat_tpu on cgat_tpu's sample embeddings, pickled in
    cgat_tpu's layout (its loop's)."""
    graphs = jload_prepared(runs["sample"], max_neighbor_number=6,
                            target="e_above_hull")
    emb = runs["jt"].embeddings(runs["params"], graphs)
    y = np.asarray([g.target for g in graphs], np.float32)
    mean, std = float(y.mean()), float(y.std(ddof=1))
    params, _ = jfit_gp(emb, (y - mean) / std, num_inducing=6, epochs=5,
                        batch_size=4, seed=0, verbose=False)
    with gzip.open(path, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "mean": mean, "std": std, "zero_mean": False}, f)


def test_error_ranking_equals_cgat_tpu(runs):
    """calculate_errors' CSVs, then get_highest_errors' ids and the pool
    shards it rewrites."""
    got_pool, want_pool = _copy_pool(runs, "e_port"), _copy_pool(runs,
                                                                 "e_jax")
    errors.calculate_errors(runs["port"], got_pool, device="cpu")
    jerrors.calculate_errors(runs["jax"], want_pool)
    _assert_scores(got_pool, want_pool)
    got = errors.get_highest_errors(got_pool, n=5,
                                    out_sample=str(runs["tmp"] / "top.pkl"))
    want = jerrors.get_highest_errors(want_pool, n=5)
    assert [shards.batch_id_str(b) for b in got["batch_ids"]] == \
        [shards.batch_id_str(b) for b in want["batch_ids"]]
    assert len(got["batch_ids"]) == 5
    for (_, g), (_, w) in zip(shards.iter_shards(got_pool),
                              shards.iter_shards(want_pool)):
        assert shards.entry_ids(shards.load_pickle(g)) == \
            jshards.entry_ids(jshards.load_pickle(w))
    assert shards.entry_ids(shards.load_pickle(
        str(runs["tmp"] / "top.pkl"))) == jshards.entry_ids(want)


def test_gp_uncertainties_equal_cgat_tpu(runs):
    """Both packages score the pool from one GP pickle of cgat_tpu's
    layout (the port reads it with cgat_tpu absent from its imports)."""
    gp_path = str(runs["tmp"] / "gp.pickle.gz")
    _jax_gp_pickle(runs, gp_path)
    got_pool, want_pool = _copy_pool(runs, "g_port"), _copy_pool(runs,
                                                                 "g_jax")
    errors.calculate_gp_uncertainties(runs["port"], gp_path, got_pool,
                                      device="cpu")
    jerrors.calculate_gp_uncertainties(runs["jax"], gp_path, want_pool)
    _assert_scores(got_pool, want_pool)


def test_embeddings_and_filter_equal_cgat_tpu(runs):
    tmp = runs["tmp"]
    embeddings.calculate_embeddings(runs["port"], runs["pool"],
                                    str(tmp / "emb_port"), device="cpu")
    jembeddings.calculate_embeddings(runs["jax"], runs["pool"],
                                     str(tmp / "emb_jax"))
    for i in range(2):
        name = os.path.basename(shards.shard_path(i, ""))
        got = shards.load_pickle(str(tmp / "emb_port" / name))
        want = jshards.load_pickle(str(tmp / "emb_jax" / name))
        assert got["input"].dtype == np.float32
        assert got["input"].shape == (N_SHARD, 2 * 8)
        np.testing.assert_allclose(got["input"], want["input"], rtol=RTOL,
                                   atol=ATOL * np.abs(want["input"]).max())
        assert got["batch_ids"] == want["batch_ids"]
    for root, pkg in (("emb_port", shards), ("emb_jax", jshards)):
        os.makedirs(tmp / root / "val")
        first = pkg.load_pickle(str(tmp / root / os.path.basename(
            shards.shard_path(0, ""))))
        pkg.save_pickle(pkg.select_entries(first, [1, 4]),
                        str(tmp / root / "val" / "v.pickle.gz"))
    embeddings.filter_embeddings(str(tmp / "emb_port"))
    jembeddings.filter_embeddings(str(tmp / "emb_jax"))
    for i in range(2):
        name = os.path.basename(shards.shard_path(i, ""))
        got = shards.load_pickle(str(tmp / "emb_port" / "train" / name))
        want = jshards.load_pickle(str(tmp / "emb_jax" / "train" / name))
        assert got["batch_ids"] == want["batch_ids"]
        assert len(got["batch_ids"]) == N_SHARD - 2 * (i == 0)


def test_ensemble_predict_and_gp_csv_equal_cgat_tpu(runs):
    tmp = runs["tmp"]
    paths = [shards.shard_path(i, runs["pool"]) for i in range(2)]
    for emb in (False, True):
        analysis.ensemble_predict([runs["port"]], paths, str(tmp / "ens_p"),
                                  export_embeddings=emb, device="cpu")
        janalysis.ensemble_predict([runs["jax"]], paths, str(tmp / "ens_j"),
                                   export_embeddings=emb)
    for p in paths:
        comp = os.path.splitext(os.path.basename(p))[0]
        for name in ("0.txt", "target.txt", "graph_embeddings.txt"):
            got = np.loadtxt(tmp / "ens_p" / comp / name)
            want = np.loadtxt(tmp / "ens_j" / comp / name)
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=ATOL * np.abs(want).max())
    gp_path = str(tmp / "gp_csv.pickle.gz")
    _jax_gp_pickle(runs, gp_path)
    emb_paths = []
    for tag, pkg in (("p", embeddings), ("j", jembeddings)):
        d = tmp / f"gpcsv_{tag}"
        (pkg.calculate_embeddings(runs["port"], paths[0], str(d),
                                  device="cpu") if tag == "p" else
         pkg.calculate_embeddings(runs["jax"], paths[0], str(d)))
        emb_paths.append(str(d / os.path.basename(paths[0])))
    analysis.gp_predict_csv(gp_path, [emb_paths[0]], target="e_above_hull",
                            device="cpu")
    janalysis.gp_predict_csv(gp_path, [emb_paths[1]], target="e_above_hull")
    gh, got = _read_csv(os.path.join(os.path.dirname(emb_paths[0]),
                                     "gp_results.csv"))
    wh, want = _read_csv(os.path.join(os.path.dirname(emb_paths[1]),
                                      "gp_results.csv"))
    assert gh == wh and len(got) == N_SHARD
    got, want = np.asarray(got, float), np.asarray(want, float)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["random", "metropolis"])
def test_initial_sample_equals_cgat_tpu(runs, method):
    got = loop.initial_sample(runs["pool"], str(runs["tmp"] / f"i_{method}"),
                              8, method=method, seed=3)
    want = jloop.initial_sample(runs["pool"],
                                str(runs["tmp"] / f"j_{method}"), 8,
                                method=method, seed=3)
    assert got["batch_ids"] == want["batch_ids"]
    np.testing.assert_array_equal(got["target"]["e_above_hull"],
                                  want["target"]["e_above_hull"])
    for (_, g), (_, w) in zip(
            shards.iter_shards(str(runs["tmp"] / f"i_{method}")),
            shards.iter_shards(str(runs["tmp"] / f"j_{method}"))):
        assert shards.load_pickle(g)["batch_ids"] == \
            jshards.load_pickle(w)["batch_ids"]


@pytest.mark.parametrize("acquisition,pretrained", [
    ("error", False), ("gp_std", False), ("error", True)])
def test_active_learning_round_on_the_cpu(runs, tmp_path, monkeypatch,
                                          acquisition, pretrained):
    """The round end to end: an initial sample of 8 of 20, a trained tiny
    model, the pool scored and 4 absorbed: 12 in the sample and 8 left in
    the pool (cgat_tpu's counts, tests/test_tools.py). Under ``gp_std``
    with 64 inducing points asked for, the fit gets as many as the sample
    has (8)."""
    pool = str(tmp_path / "al")
    sample = loop.initial_sample(runs["pool"], pool, 8, seed=1)
    sample_path = str(tmp_path / "sample.pickle.gz")
    shards.save_pickle(sample, sample_path)
    fits = []
    fit_gp = port_gp.fit_gp

    def recorded(*args, **kwargs):
        fits.append(kwargs["num_inducing"])
        return fit_gp(*args, **kwargs)
    monkeypatch.setattr(port_gp, "fit_gp", recorded)
    tcfg = TrainerConfig(**TRAIN, ckpt_dir=str(tmp_path), run_name="r")
    run_dir, new = loop.active_learning_round(
        pool, sample_path, trainer_cfg=tcfg, model_cfg=CGATConfig(**TINY),
        n_new=4, acquisition=acquisition,
        pretrained_run=runs["port"] if pretrained else None,
        gp_kwargs=dict(num_inducing=64, epochs=3, batch_size=4),
        device="cpu")
    assert os.path.isfile(os.path.join(run_dir, "checkpoints", "best.pt"))
    assert new is not None and len(new["batch_ids"]) == 4
    merged = shards.load_pickle(sample_path)
    assert len(merged["batch_ids"]) == 12
    left = [b for _, p in shards.iter_shards(pool)
            for b in shards.entry_ids(shards.load_pickle(p))]
    assert len(left) == 8
    assert not set(left) & set(shards.entry_ids(merged))
    assert fits == ([8] if acquisition == "gp_std" else [])
    scores = [float(r[1]) for i in range(2) for r in _read_csv(
        errors.error_csv_path(i, pool))[1]]
    assert scores and all(np.isfinite(scores))
    if acquisition == "gp_std":
        assert all(s > 0 for s in scores)


# ------------------------------------------------------------------ t-SNE

def _clusters(n_per, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((n_per, dim)) + c
                           for c in (0.0, 4.0, -4.0)]).astype(np.float32)


def _kl(p, y):
    """KL(P || Q(y)) over the off-diagonal pairs (full-matrix P)."""
    d = pairwise_distances(y, squared=True)
    w = 1.0 / (1.0 + d)
    np.fill_diagonal(w, 0.0)
    q = np.maximum(w / w.sum(), np.finfo(float).eps)
    off = ~np.eye(len(y), dtype=bool)
    return float((p[off] * np.log(p[off] / q[off])).sum())


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_tsne_affinities_equal_sklearn(perplexity):
    x = _clusters(20)
    want = squareform(_t_sne._joint_probabilities(
        pairwise_distances(x, squared=True), perplexity, 0))
    got = analysis.joint_probabilities(
        analysis.squared_distances(torch.from_numpy(x)), perplexity)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got.sum()) == pytest.approx(1.0)


def test_tsne_matches_cgat_tpu_quality():
    """On 60 points the port's exact t-SNE reaches a KL within 10 % of
    cgat_tpu's ``tsne_embed`` (scikit-learn's) and a trustworthiness
    within 0.03 of it (k = 5)."""
    x = _clusters(20)
    p = squareform(_t_sne._joint_probabilities(
        pairwise_distances(x, squared=True), 30.0, 0))
    got = analysis.tsne_embed(x, device="cpu")
    want = janalysis.tsne_embed(x)
    assert got.shape == (60, 2) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert _kl(p, got) <= 1.1 * _kl(p, want)
    assert trustworthiness(x, got, n_neighbors=5) >= \
        trustworthiness(x, want, n_neighbors=5) - 0.03


def test_tsne_cli_writes_a_row_a_point(tmp_path):
    rng = np.random.default_rng(0)
    data = {"input": rng.standard_normal((30, 8)).astype(np.float32),
            "batch_ids": [[f"{i},1"] for i in range(30)],
            "batch_comp": np.asarray(["x"] * 30, dtype=object),
            "target": {"e_above_hull": rng.standard_normal(30)},
            "comps": np.asarray(["x"] * 30, dtype=object)}
    path = tmp_path / "emb.pickle.gz"
    shards.save_pickle(data, str(path))
    out = tmp_path / "tsne.csv"
    assert tsne_cli.main([str(path), "--target", "e_above_hull",
                          "--perplexity", "5", "--out", str(out),
                          "--device", "cpu"]) == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 31 and rows[0].startswith("x,y,target")
