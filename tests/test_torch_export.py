"""The port's serving export against cgat_tpu, on the CPU: the state_dict
to flat-arrays converter against cgat_tpu's ``_flatten_params``, a port
run exported and served against the live trainer and against cgat_tpu's
forward on the same weights, and ``cli.export``'s artifact, which
cgat_tpu's loader refuses with its own error."""
import json

import jax
import numpy as np
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.serving import load_artifact as jload_artifact
from cgat_tpu.serving.artifact import _flatten_params, _unflatten_params
from cgat_tpu_torch.cli import export as cli_export
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import (CGATConfig, flat_from_state_dict,
                                   state_dict_from_jax)
from cgat_tpu_torch.serving import export_artifact, load_artifact
from cgat_tpu_torch.training import Trainer, TrainerConfig

# Start torch's CPU thread pool before JAX's runtime (see
# tests/test_torch_training.py).
torch.exp(torch.zeros(1 << 20))

KW = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
          nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
          n_graph_roost=1, out_hidden=(16, 8))
GRAPHS = dict(n_atoms_range=(3, 7), max_nbr=4, orig_fea=16)
# 8, 16 and 32 node slots: a batch of 4 crystals of 3 to 7 atoms takes the
# second or the third
TRAIN = dict(batch_size=4, node_bucket=8, max_nbr=4, num_comp_slots=8,
             learning_rate=3e-3, check_val_every_n_epoch=1, epochs=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the ops are tiny, and beside the other
    test processes a thread pool only contends. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", [
    {}, {"no_hyper": False}, {"update_edges": False},
    {"split_projection": True}])
def test_flat_params_round_trip_and_equal_cgat_tpu(variant):
    """JAX parameters -> the port's state_dict -> flat arrays gives
    cgat_tpu's ``_flatten_params`` of those parameters exactly (keys,
    shapes, f32 bits), and flat -> state_dict -> flat is the identity,
    for the default model and each variant ``state_dict_from_jax``
    covers."""
    example = jcollate(jrandom_graphs(0, 2, **GRAPHS), max_nbr=4,
                       node_bucket=8)
    params = init_params_host(JNet(JConfig(**KW, **variant)), example, seed=1)
    want = _flatten_params(params)
    cfg = CGATConfig(**KW, **variant)
    sd = state_dict_from_jax(want, cfg)
    got = flat_from_state_dict(sd)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    again = state_dict_from_jax(got, cfg)
    assert again.keys() == sd.keys()
    assert all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run of one epoch (f32) with its ``best`` checkpoint, and the
    live trainer."""
    d = tmp_path_factory.mktemp("runs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = Trainer(TrainerConfig(**TRAIN, ckpt_dir=str(d), run_name="r"),
                    CGATConfig(**KW), random_graphs(0, 40, **GRAPHS),
                    device="cpu")
        t.fit()
    finally:
        torch.set_num_threads(n)
    return d / "runs" / "r", t


def _jax_predict(params, cfg, manifest, graphs):
    """cgat_tpu's forward, chunk by chunk at the artifact's smallest
    signature that fits: denormalised predictions and embeddings."""
    model = JNet(cfg)
    sigs = sorted(manifest["signatures"], key=lambda s: s["num_node_slots"])
    C = sigs[0]["num_graphs"]
    preds, embs, used = [], [], set()
    for i in range(0, len(graphs), C):
        chunk = graphs[i:i + C]
        sig = next(s for s in sigs
                   if s["num_node_slots"] >= sum(g.n_atoms for g in chunk))
        used.add(sig["num_node_slots"])
        batch = jcollate(chunk, num_graphs=C,
                         num_node_slots=sig["num_node_slots"],
                         num_edge_slots=sig["num_edge_slots"],
                         num_comp_slots=sig["num_comp_slots"], max_nbr=4,
                         orig_fea=16)
        out = np.asarray(model.apply({"params": params}, batch))
        emb = np.asarray(model.apply({"params": params}, batch,
                                     return_graph_embedding=True))
        preds.append(out[:len(chunk), 0] * manifest["std"]
                     + manifest["mean"])
        embs.append(emb[:len(chunk)])
    return np.concatenate(preds), np.concatenate(embs), used


def test_exported_run_predicts_like_the_trainer_and_cgat_tpu(run, tmp_path):
    """``export_artifact`` on a port run, served by ``load_artifact`` on the
    CPU: the live trainer's predictions (f32, rtol 1e-5) and cgat_tpu's
    forward on the artifact's ``params.npz`` (predictions and embeddings),
    in input order, across the signatures the batches pick."""
    run_dir, trainer = run
    manifest = export_artifact(str(run_dir), str(tmp_path / "art"))
    served = load_artifact(str(tmp_path / "art"), device="cpu")
    assert served.graphs is None
    graphs = random_graphs(5, 30, **GRAPHS)
    pred, log_std, emb = served.predict(graphs, return_embeddings=True)
    assert pred.shape == log_std.shape == (30,) and emb.shape[0] == 30
    np.testing.assert_allclose(pred, trainer.predict(graphs), rtol=1e-5,
                               atol=1e-6)
    with np.load(tmp_path / "art" / "params.npz") as z:
        params = _unflatten_params({k: z[k] for k in z.files})
    want, want_emb, used = _jax_predict(
        params, JConfig(**KW), manifest, jrandom_graphs(5, 30, **GRAPHS))
    assert used == {16, 32}
    np.testing.assert_allclose(pred, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb, want_emb, rtol=1e-5, atol=1e-5)


def test_cli_export_writes_an_artifact_cgat_tpu_refuses(run, tmp_path, capsys):
    """``cli.export`` writes the manifest of cgat_tpu's format (1x, 2x and
    4x the node bucket, E = N * max_nbr, no module files, the platforms
    recorded, the source run) beside the f32 master weights; cgat_tpu's
    ``load_artifact`` raises its own ``ValueError``; a platform the port
    cannot serve on raises, naming cgat_tpu's exporter."""
    run_dir, trainer = run
    out = tmp_path / "art"
    assert cli_export.main([str(run_dir), str(out), "--platforms", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"wrote {out} (c4_n8, c4_n16, c4_n32; platforms cpu)")
    manifest = json.loads((out / "manifest.json").read_text())
    meta = json.loads((run_dir / "checkpoints" / "best.json").read_text())
    assert manifest["format"] == 2 and manifest["platforms"] == ["cpu"]
    assert [(s["key"], s["num_node_slots"], s["num_edge_slots"],
             s["num_comp_slots"], s["files"]) for s in manifest["signatures"]
            ] == [(f"c4_n{n}", n, 4 * n, 8, {}) for n in (8, 16, 32)]
    assert (manifest["mean"], manifest["std"]) == (meta["mean"], meta["std"])
    assert manifest["source_run"] == str(run_dir.resolve())
    assert (manifest["checkpoint_tag"], manifest["checkpoint_epoch"],
            manifest["val_mae"]) == ("best", meta["epoch"], meta["val_mae"])
    assert manifest["collate"]["max_nbr"] == 4
    with np.load(out / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    want = flat_from_state_dict(trainer.model.state_dict())
    assert flat.keys() == want.keys()
    assert all(np.array_equal(flat[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="artifact was lowered for"):
        jload_artifact(str(out))
    with pytest.raises(ValueError, match="cgat_tpu.cli.export"):
        cli_export.main([str(run_dir), str(tmp_path / "x"),
                         "--platforms", "tpu"])
    assert cli_export.main([str(run_dir), str(tmp_path / "b"),
                            "--node-buckets", "24", "--batch-size", "2",
                            "--tag", "last"]) == 0
    m = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert m["platforms"] == ["cuda", "cpu"] and [
        s["key"] for s in m["signatures"]] == ["c2_n24"]
