"""The port's GP head (``cgat_tpu_torch.uncertainty``, ``cli.train_gp``)
against cgat_tpu's on the CPU, on the same numpy inputs: the SVGP's
functions (rtol 1e-5) and the ELBO's gradient against ``jax.grad`` (rtol
1e-4); ``fit_gp`` and ``fit_gp_streaming`` trajectories at the
tolerances of ``tests/test_gp.py`` (history rtol 1e-4 / atol 1e-5,
parameters rtol 1e-2 / atol 1e-3: padding-level differences are
normalised by Adam to O(lr)); the behaviour ``tests/test_gp.py`` checks;
``cli.train_gp`` in both modes on a tiny port run; and ``load_gp`` of a
cgat_tpu-written pickle in a process that never imports cgat_tpu. A
replayed GP step on the card is ``tests/test_torch_gpu.py``'s."""
import dataclasses
import gzip
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu import uncertainty as jgp
from cgat_tpu_torch import uncertainty as gp
from cgat_tpu_torch.cli import prepare as cli_prepare
from cgat_tpu_torch.cli import train_gp as cli_train_gp
from cgat_tpu_torch.data.dataset import load_dataset_dir, split_dataset
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, CGAtNet, state_dict_from_jax
from cgat_tpu_torch.training import Trainer, TrainerConfig, load_trainer

ROOT = Path(__file__).resolve().parents[1]
# Start torch's CPU thread pool before JAX's runtime (see
# tests/test_torch_training.py).
torch.exp(torch.zeros(1 << 20))

# the model of tests/test_gp.py and tests/test_gp_cli.py
TINY = dict(orig_elem_fea_len=12, elem_fea_len=8, n_graph=1,
            nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
            n_graph_roost=1, out_hidden=(8,))
GRAPHS = dict(n_atoms_range=(3, 6), max_nbr=4, orig_fea=12)
FIELDS = [f.name for f in dataclasses.fields(gp.GPParams)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (see ``tests/test_torch_dispatch.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, m=6, d=3):
    """Random SVGP parameters as numpy: a lower factor with a positive
    diagonal and junk above it (both packages read its lower triangle)."""
    rng = np.random.default_rng(seed)
    chol = rng.standard_normal((m, m)).astype(np.float32) * 0.3
    chol[np.diag_indices(m)] = rng.uniform(0.5, 1.5, m)
    return {"inducing": rng.standard_normal((m, d)).astype(np.float32),
            "var_mean": rng.standard_normal(m).astype(np.float32),
            "var_chol": chol,
            "raw_lengthscale": np.float32(rng.uniform(-0.5, 0.5)),
            "raw_outputscale": np.float32(rng.uniform(-0.5, 0.5)),
            "raw_noise": np.float32(rng.uniform(-1.0, 0.0)),
            "mean_const": np.float32(rng.standard_normal())}


def _both(p):
    return (jgp.GPParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            gp.GPParams(**{k: torch.tensor(v) for k, v in p.items()}))


def _xy(seed, b=9, d=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal(b).astype(np.float32),
            rng.random(b) < 0.7)


def _close(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("fn", ["kl", "predict_f", "predict_y", "elbo",
                                "elbo_masked", "zero_mean_elbo"])
def test_svgp_functions_match_cgat_tpu(fn):
    jp, tp = _both(_params(0))
    x, y, mask = _xy(1)
    tx, ty = torch.tensor(x), torch.tensor(y)
    if fn == "kl":
        got, want = [gp.kl_divergence(tp)], [jgp.kl_divergence(jp)]
    elif fn.startswith("predict"):
        name = f"gp_{fn}"
        got, want = getattr(gp, name)(tp, tx), getattr(jgp, name)(jp, x)
    else:
        m = mask if fn == "elbo_masked" else None
        cfg = (dict(cfg=gp.GPConfig(zero_mean=True)),
               dict(cfg=jgp.GPConfig(zero_mean=True))) \
            if fn == "zero_mean_elbo" else ({}, {})
        got = [gp.elbo(tp, tx, ty, 40, mask=None if m is None
                       else torch.tensor(m), **cfg[0])]
        want = [jgp.elbo(jp, x, y, 40, mask=m, **cfg[1])]
    _close(got, want, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_elbo_gradient_matches_jax_grad(masked):
    jp, tp = _both(_params(2))
    x, y, mask = _xy(3)
    m = mask if masked else None
    want = jax.grad(lambda p: jgp.elbo(p, x, y, 40, mask=m))(jp)
    tp = tp.map(lambda t: t.requires_grad_())
    gp.elbo(tp, torch.tensor(x), torch.tensor(y), 40,
            mask=None if m is None else torch.tensor(m)).backward()
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(tp, name).grad.numpy(), np.asarray(getattr(want, name)),
            rtol=1e-4, atol=1e-6, err_msg=name)


def _assert_fit_close(got, want):
    """History and parameters at ``tests/test_gp.py:94-98``'s
    tolerances."""
    (tp, th), (jp, jh) = got, want
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-5)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-2, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("zero_mean", [False, True])
def test_fit_gp_matches_cgat_tpu(zero_mean):
    """5 epochs of 3 batches from 10 inducing rows: the same inducing
    draw and epoch orders (one numpy generator), optax.adam against the
    port's Adam; under zero_mean the mean stays 0."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((100, 5)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(100)).astype(np.float32)
    kw = dict(num_inducing=10, epochs=5, batch_size=32, learning_rate=1e-2,
              seed=3, verbose=False)
    got = gp.fit_gp(x, y, cfg=gp.GPConfig(zero_mean=zero_mean),
                    device="cpu", **kw)
    want = jgp.fit_gp(x, y, cfg=jgp.GPConfig(zero_mean=zero_mean), **kw)
    _assert_fit_close(got, want)
    assert (float(got[0].mean_const) == 0.0) == zero_mean


def _model_pair(seed=0):
    """cgat_tpu's tiny model and the port's with its weights, f32."""
    graphs = jrandom_graphs(0, 24, **GRAPHS)
    model = JNet(JConfig(**TINY))
    batch = jcollate(graphs, max_nbr=4, node_bucket=8, num_comp_slots=8)
    params = model.init(jax.random.key(seed), batch)["params"]
    cfg = CGATConfig(**TINY)
    port = CGAtNet(cfg)
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.array, params),
                                             cfg), strict=True)
    return model, params, graphs, port


def test_fit_gp_streaming_matches_cgat_tpu():
    """On-the-fly fits from the same weights (carried by
    ``state_dict_from_jax``) and the same 24 graphs: 5 epochs of 3
    shuffled batches of 8, inducing points embedded from 8 graphs."""
    model, params, jgraphs, port = _model_pair()
    graphs = random_graphs(0, 24, **GRAPHS)
    y = np.asarray([g.target for g in graphs], np.float32)
    assert [g.target for g in graphs] == [g.target for g in jgraphs]
    kw = dict(mean=float(y.mean()), std=float(y.std(ddof=1)),
              num_inducing=8, epochs=5, batch_size=8, learning_rate=1e-2,
              seed=0, max_nbr=4, node_bucket=8, num_comp_slots=8,
              verbose=False)
    got = gp.fit_gp_streaming(port.train(), graphs, **kw)
    assert port.training        # its mode is restored
    want = jgp.fit_gp_streaming(model, params, jgraphs, **kw)
    _assert_fit_close(got, want)


def test_streaming_matches_precomputed_full_batch():
    """``tests/test_gp.py``'s check in the port: with one full batch an
    epoch, the on-the-fly fit reproduces the fit on precomputed
    embeddings (the same inducing draw, an order-free ELBO)."""
    _, _, _, port = _model_pair()
    graphs = random_graphs(0, 24, **GRAPHS)
    t = Trainer(TrainerConfig(batch_size=24, max_nbr=4, node_bucket=8,
                              num_comp_slots=8), CGATConfig(**TINY), graphs,
                mean=0.0, std=1.0, device="cpu")
    t.init_state(port.state_dict())
    emb = t.embeddings(graphs)
    y = np.asarray([g.target for g in graphs], np.float32)
    mean, std = float(y.mean()), float(y.std(ddof=1))
    kw = dict(num_inducing=8, epochs=5, batch_size=64, learning_rate=1e-2,
              seed=0, verbose=False)
    _assert_fit_close(
        gp.fit_gp_streaming(port.eval(), graphs, mean=mean, std=std,
                            max_nbr=4, node_bucket=8, num_comp_slots=8, **kw),
        (lambda p, h: (p.map(lambda t: t.numpy()), h))(
            *gp.fit_gp(emb, (y - mean) / std, device="cpu", **kw)))


def test_kl_zero_at_standard_normal():
    params = gp.init_gp(np.random.default_rng(0).standard_normal((5, 3)))
    assert abs(float(gp.kl_divergence(params))) < 1e-6


def test_prior_predictive_matches_kernel():
    """With m = 0 and S = I the whitened q(f) is the GP prior."""
    rng = np.random.default_rng(1)
    params = gp.init_gp(rng.standard_normal((8, 2)).astype(np.float32))
    x = torch.tensor(rng.standard_normal((4, 2)), dtype=torch.float32)
    mean, var = gp.gp_predict_f(params, x)
    np.testing.assert_allclose(mean.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.log(2.0), rtol=1e-4)


def test_elbo_increases_during_fit():
    rng = np.random.default_rng(2)
    x = rng.uniform(-3, 3, size=(256, 1)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(256).astype(np.float32)
    params, history = gp.fit_gp(x, y, num_inducing=32, epochs=250,
                                batch_size=256, learning_rate=5e-2,
                                verbose=False, device="cpu")
    assert history[-1] < history[0]
    tx = torch.tensor(x)
    mu, _ = gp.gp_predict_f(params, tx)
    assert float(np.mean(np.abs(mu.numpy() - y))) < 0.15
    lo, hi = gp.confidence_region(*gp.gp_predict_y(params, tx))
    frac = float(np.mean((y >= lo.numpy()) & (y <= hi.numpy())))
    assert frac > 0.85, frac


def test_uncertainty_grows_off_data():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(128, 1)).astype(np.float32)
    params, _ = gp.fit_gp(x, x[:, 0] ** 2, num_inducing=16, epochs=100,
                          batch_size=128, learning_rate=5e-2, verbose=False,
                          device="cpu")
    _, var_in = gp.gp_predict_f(params, torch.tensor([[0.0]]))
    _, var_out = gp.gp_predict_f(params, torch.tensor([[30.0]]))
    assert float(var_out[0]) > float(var_in[0])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny port run trained for one epoch on 40 prepared crystals."""
    d = tmp_path_factory.mktemp("gp_run")
    with gzip.open(d / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 40), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(d), "--target-dir", str(d), "--target-file",
                             "prepared.pickle.gz", "--max-nbr", "4"]) == 0
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = Trainer(TrainerConfig(
            data_path=str(d / "prepared.pickle.gz"), target="e_above_hull",
            max_nbr=4, batch_size=8, node_bucket=8, epochs=1,
            check_val_every_n_epoch=1, ckpt_dir=str(d), run_name="r"),
            CGATConfig(**{**TINY, "orig_elem_fea_len": 200}), device="cpu")
        t.fit()
    finally:
        torch.set_num_threads(n)
    return d


@pytest.mark.parametrize("mode", ["precomputed", "on_the_fly", "embeddings"])
def test_cli_train_gp_on_a_port_run(port_run, tmp_path, mode):
    """``cli.train_gp`` on the run: a pickle of cgat_tpu's keys with a
    finite val MAE, the GP over the embedding width; precomputed, it is
    ``fit_gp`` on the run's embeddings of the seeded training split; from
    ``--embedding-path`` the same."""
    run = str(port_run / "runs" / "r")
    out = tmp_path / "gp.pickle.gz"
    argv = ["--cgat-model", run, "--inducing-points", "8", "--epochs", "3",
            "--batch-size", "8", "--device", "cpu", "--out", str(out)]
    trainer, _ = load_trainer(run, device="cpu")
    graphs = load_dataset_dir(trainer.cfg.data_path, max_neighbor_number=4,
                              target="e_above_hull")
    emb = trainer.embeddings(graphs)
    y = np.asarray([g.target for g in graphs], np.float32)
    if mode == "on_the_fly":
        argv.append("--on-the-fly")
    if mode == "embeddings":
        path = tmp_path / "emb.pickle.gz"
        with gzip.open(path, "wb") as f:
            pickle.dump({"input": emb, "target": {"e_above_hull": y}}, f)
        argv += ["--embedding-path", str(path)]
    assert cli_train_gp.main(argv) == 0
    with gzip.open(out, "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == {"params", "mean", "std", "zero_mean", "val_mae",
                          "history"}
    assert np.isfinite(saved["val_mae"]) and len(saved["history"]) == 3
    assert saved["params"].inducing.shape == (
        8, CGATConfig(**TINY).embedding_dim)
    if mode != "on_the_fly":
        tr, _, _ = split_dataset(len(graphs), seed=0)
        mean, std = float(np.mean(y[tr])), float(np.std(y[tr], ddof=1))
        params, history = gp.fit_gp(
            emb[tr], (y[tr] - mean) / std, num_inducing=8, epochs=3,
            batch_size=8, verbose=False, device="cpu")
        assert saved["history"] == history
        assert np.array_equal(saved["params"].var_chol,
                              params.var_chol.numpy())


def test_load_gp_reads_a_cgat_tpu_pickle_without_importing_it(tmp_path):
    """A pickle as cgat_tpu's ``train_gp_from_checkpoint`` writes it
    (its flax ``GPParams`` of numpy arrays) loads in a process where
    neither cgat_tpu nor JAX is ever imported, into the port's
    ``GPParams`` with the same values."""
    jp, _ = _both(_params(5))
    path = tmp_path / "jax_gp.pickle.gz"
    with gzip.open(path, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, jp), "mean": 0.5,
                     "std": 2.0, "zero_mean": False, "val_mae": 0.1,
                     "history": [1.0, 0.5]}, f)
    code = (
        "import json, sys\n"
        "from cgat_tpu_torch.uncertainty import load_gp, gp_predict_f\n"
        f"p, d = load_gp({str(path)!r}, device='cpu')\n"
        "import torch\n"
        "mean, var = gp_predict_f(p, torch.zeros(2, 3))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'cgat_tpu')]\n"
        "print(json.dumps({'bad': bad, 'type': type(p).__module__, "
        "'chol': p.var_chol.tolist(), 'noise': float(p.raw_noise), "
        "'mean': mean.tolist(), 'std': d['std']}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["std"] == 2.0
    assert got["type"] == "cgat_tpu_torch.uncertainty.gp"
    assert np.array_equal(np.float32(got["chol"]), np.asarray(jp.var_chol))
    assert np.float32(got["noise"]) == np.asarray(jp.raw_noise)
    want, _ = jgp.gp_predict_f(jp, jnp.zeros((2, 3)))
    np.testing.assert_allclose(got["mean"], np.asarray(want), rtol=1e-5)
