"""The port's serving entry points against the JAX model, and the port's
isolation from JAX."""
import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.serving.artifact import _flatten_params
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.serving import load_artifact

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
          nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
          n_graph_roost=1, out_hidden=(16, 8))
C, MEAN, STD = 4, 1.5, 0.5


def _signature(n):
    return {"key": f"c{C}_n{n}", "num_graphs": C, "num_node_slots": n,
            "num_edge_slots": n * 4, "num_comp_slots": 8,
            "files": {"cpu": f"fn_c{C}_n{n}_cpu.bin"}}


def _write_artifact(out, cfg):
    """An artifact directory written the way export_artifact writes one
    (the JAX fn_*.bin modules are not needed by the port)."""
    model = JNet(cfg)
    example = jcollate(jrandom_graphs(0, 2, max_nbr=4, orig_fea=16),
                       max_nbr=4, node_bucket=8)
    params = init_params_host(model, example, seed=1)
    np.savez_compressed(out / "params.npz", **_flatten_params(params))
    manifest = {"format": 2, "mean": MEAN, "std": STD,
                "model_config": dataclasses.asdict(cfg),
                "collate": {"max_nbr": 4, "num_comp_slots": 8,
                            "orig_fea": 16, "node_bucket": 8},
                "platforms": ["cpu"],
                "signatures": [_signature(16), _signature(32)]}
    (out / "manifest.json").write_text(json.dumps(manifest))
    return str(out), model, params


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _write_artifact(tmp_path_factory.mktemp("artifact"), JConfig(**KW))


def _jax_predict(model, params, graphs):
    """The JAX model's denormalised output and embeddings, chunk by chunk
    with the artifact's signatures."""
    preds, log_stds, embs = [], [], []
    for i in range(0, len(graphs), C):
        chunk = graphs[i:i + C]
        n = 16 if sum(g.n_atoms for g in chunk) <= 16 else 32
        batch = jcollate(chunk, num_graphs=C, num_node_slots=n,
                         num_edge_slots=n * 4, num_comp_slots=8, max_nbr=4,
                         orig_fea=16)
        out = np.asarray(model.apply({"params": params}, batch))
        emb = np.asarray(model.apply({"params": params}, batch,
                                     return_graph_embedding=True))
        preds.append(out[:len(chunk), 0] * STD + MEAN)
        log_stds.append(out[:len(chunk), 1])
        embs.append(emb[:len(chunk)])
    return np.concatenate(preds), np.concatenate(log_stds), np.concatenate(embs)


def test_predict_matches_jax_in_input_order(artifact):
    path, model, params = artifact
    served = load_artifact(path, device="cpu")
    # 10 crystals with 4 per batch: two full batches and a padded tail
    kw = dict(n_atoms_range=(2, 7), max_nbr=4, orig_fea=16)
    preds, log_stds, embs = served.predict(random_graphs(3, 10, **kw),
                                           return_embeddings=True)
    assert preds.shape == log_stds.shape == (10,)
    assert embs.shape == (10, JConfig(**KW).embedding_dim)
    want = _jax_predict(model, params, jrandom_graphs(3, 10, **kw))
    for got, w in zip((preds, log_stds, embs), want):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5)
    again, _ = served.predict(random_graphs(3, 10, **kw))
    np.testing.assert_array_equal(again, preds)


@pytest.mark.parametrize("variant", [{"no_hyper": False},
                                     {"update_edges": False}])
def test_variant_artifacts_match_jax(variant, tmp_path):
    """An artifact of a hyper-edge or a node-only model: the manifest's
    config keeps the variant, and the port predicts what JAX does."""
    path, model, params = _write_artifact(tmp_path, JConfig(**KW, **variant))
    served = load_artifact(path, device="cpu")
    for k, v in variant.items():
        assert getattr(served.model.config, k) == v
    kw = dict(n_atoms_range=(2, 7), max_nbr=4, orig_fea=16)
    got = served.predict(random_graphs(4, 6, **kw), return_embeddings=True)
    want = _jax_predict(model, params, jrandom_graphs(4, 6, **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_predict_rejects_batches_beyond_every_signature(artifact):
    served = load_artifact(artifact[0], device="cpu")
    big = random_graphs(1, 4, n_atoms_range=(9, 10), max_nbr=4, orig_fea=16)
    with pytest.raises(ValueError):
        served.predict(big)


def test_load_artifact_rejects_unknown_format(artifact, tmp_path):
    manifest = json.loads((pathlib.Path(artifact[0]) / "manifest.json")
                          .read_text())
    (tmp_path / "manifest.json").write_text(json.dumps({**manifest,
                                                        "format": 1}))
    with pytest.raises(ValueError, match="format"):
        load_artifact(str(tmp_path), device="cpu")


def test_load_artifact_without_device_needs_cuda(artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_artifact(artifact[0])


def _port_files():
    return sorted((ROOT / "cgat_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    banned = ("jax", "flax", "optax", "sklearn", "pymatgen", "cgat_tpu")
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert len(_port_files()) > 10
    assert not bad, bad


def test_port_runs_without_jax_loaded():
    code = ("import sys, cgat_tpu_torch.serving, cgat_tpu_torch.models, "
            "cgat_tpu_torch.data.synthetic, cgat_tpu_torch.data.dataset, "
            "cgat_tpu_torch.ops, cgat_tpu_torch.training, "
            "cgat_tpu_torch.data.featurizer, cgat_tpu_torch.native, "
            "cgat_tpu_torch.cli.common, cgat_tpu_torch.cli.prepare, "
            "cgat_tpu_torch.cli.train, cgat_tpu_torch.cli.evaluate, "
            "cgat_tpu_torch.cli.predict, cgat_tpu_torch.cli.train_gp, "
            "cgat_tpu_torch.uncertainty, cgat_tpu_torch.ops.kernels.dropout, "
            "cgat_tpu_torch.tools, cgat_tpu_torch.tools.additional_data, "
            "cgat_tpu_torch.tools.analysis, cgat_tpu_torch.tools.annotate, "
            "cgat_tpu_torch.tools.element_correlation, "
            "cgat_tpu_torch.tools.embeddings, cgat_tpu_torch.tools.errors, "
            "cgat_tpu_torch.tools.loop, cgat_tpu_torch.tools.metropolis, "
            "cgat_tpu_torch.tools.periodic, cgat_tpu_torch.tools.sample, "
            "cgat_tpu_torch.tools.shards, cgat_tpu_torch.tools.tsne, "
            "cgat_tpu_torch.tools.ensemble, cgat_tpu_torch.tools.import_torch, "
            "cgat_tpu_torch.tools.step_trace, cgat_tpu_torch.utils.roofline, "
            "cgat_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'sklearn', 'pymatgen', 'cgat_tpu')]; "
            "print(bad); "
            "sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
