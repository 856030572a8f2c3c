"""The port's out-of-core training and prefetch against cgat_tpu, on the
CPU: the shard scan and its shared sidecar, the streaming loader, the
streaming grouped loader, the prefetcher, a streaming fit against
cgat_tpu's streaming Trainer, and a streaming resume."""
import gzip
import json
import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

import cgat_tpu.data.streaming as jstreaming
import cgat_tpu_torch.data.streaming as streaming
import cgat_tpu_torch.training.trainer as trainer_module
from cgat_tpu.data.prefetch import PrefetchLoader as JPrefetchLoader
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.parallel import StreamingParallelLoader as JStreamingParallel
from cgat_tpu.training import Trainer as JTrainer
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu_torch.data.dataset import GraphLoader
from cgat_tpu_torch.data.prefetch import PrefetchLoader
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, state_dict_from_jax
from cgat_tpu_torch.parallel import StreamingParallelLoader
from cgat_tpu_torch.training import Trainer, TrainerConfig, resume_trainer

# Start torch's CPU thread pool before JAX's runtime (see
# tests/test_torch_training.py).
torch.exp(torch.zeros(1 << 20))

ELEMENTS = ["Na", "Cl", "K", "O"]
TINY = dict(orig_elem_fea_len=16, elem_fea_len=8, n_graph=2,
            nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
            n_graph_roost=1, out_hidden=(16, 8))
LOADER = dict(target="e_above_hull", max_nbr=4, node_bucket=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the ops are tiny, and beside the other
    test processes a thread pool only contends. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prepared(n, id_offset=0, seed=0):
    """A prepared-dataset dict of ``n`` crystals of 2 to 5 atoms with 4
    neighbours each (the layout ``cli.prepare`` writes)."""
    rng = np.random.default_rng(seed)
    inputs = np.empty((3, n), dtype=object)
    comps, batch_comp = [], []
    for i in range(n):
        na = int(rng.integers(2, 6))
        inputs[0, i] = rng.integers(1, 5, (na, 4))
        inputs[1, i] = np.repeat(np.arange(na)[:, None], 4, 1)
        inputs[2, i] = rng.integers(0, na, (na, 4))
        els = [ELEMENTS[int(x)] for x in rng.integers(0, len(ELEMENTS), na)]
        comps.append(np.asarray(els, dtype=object))
        cnt = {}
        for e in els:
            cnt[e] = cnt.get(e, 0) + 1
        batch_comp.append(" ".join(f"{k}{v}" for k, v in cnt.items()))
    return {"input": inputs,
            "batch_ids": [[f"{id_offset + i},225"] for i in range(n)],
            "batch_comp": np.asarray(batch_comp, dtype=object),
            "target": {"e_above_hull": rng.standard_normal(n)},
            "comps": np.asarray(comps, dtype=object)}


def _write_shards(d, sizes, seed=0):
    os.makedirs(d, exist_ok=True)
    off = 0
    for i, n in enumerate(sizes):
        with gzip.open(os.path.join(d, f"shard_{i:04d}.pickle.gz"), "wb") as f:
            pickle.dump(_prepared(n, id_offset=off, seed=seed + i), f)
        off += n
    return str(d)


@pytest.fixture
def fea16(tmp_path):
    rng = np.random.default_rng(42)
    path = tmp_path / "fea16.json"
    path.write_text(json.dumps({el: rng.standard_normal(16).tolist()
                                for el in ELEMENTS}))
    return str(path)


@pytest.fixture
def pool(tmp_path):
    """Three shards of 17, 16 and 15 crystals: batches straddle shards."""
    return _write_shards(tmp_path / "pool", [17, 16, 15])


@pytest.fixture
def val_dir(tmp_path):
    return _write_shards(tmp_path / "val", [8], seed=9)


def _equal_batches(b, jb, what):
    for name in b.__dataclass_fields__:
        got, want = getattr(b, name), getattr(jb, name, None)
        if got is None:
            assert want is None, (what, name)
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{what}: {name}")


def test_scan_metadata_equals_cgat_tpu_and_shares_the_sidecar(
        pool, fea16, monkeypatch):
    """The same dict as cgat_tpu's scan (counts exact, mean and std to
    1e-12) and the same sidecar bytes; each package reads the sidecar the
    other wrote (its own shard parser broken meanwhile)."""
    kw = dict(target="e_above_hull", fea_path=fea16, max_nbr=4)
    want = jstreaming.scan_shard_metadata(pool, cache=False, **kw)
    got = streaming.scan_shard_metadata(pool, **kw)
    assert got.keys() == want.keys()
    for k in ("key", "target", "max_nbr", "n_graphs", "num_comp_slots",
              "max_degree", "per_shard_counts"):
        assert got[k] == want[k], k
    assert got["n_graphs"] == 48 and got["per_shard_counts"] == [17, 16, 15]
    for k in ("mean", "std"):
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), k
    sidecar = os.path.join(pool, ".cgat_meta.json")
    port_text = open(sidecar).read()

    def broken(*args, **kwargs):
        raise AssertionError("the sidecar should have been read")

    with monkeypatch.context() as m:
        m.setattr(jstreaming, "load_prepared", broken)
        assert jstreaming.scan_shard_metadata(pool, **kw) == got
    os.remove(sidecar)
    jstreaming.scan_shard_metadata(pool, **kw)
    assert open(sidecar).read() == port_text
    monkeypatch.setattr(streaming, "load_prepared", broken)
    assert streaming.scan_shard_metadata(pool, **kw) == got


@pytest.mark.parametrize("prefetch,index,count,drop_last", [
    (True, 0, 1, True), (False, 0, 1, False), (True, 1, 2, True)])
def test_streaming_loader_equals_cgat_tpu(pool, fea16, prefetch, index,
                                          count, drop_last):
    """Two epochs of shuffled batches field for field cgat_tpu's, with the
    next shard parsed on a thread or not, a process's slice of the shards,
    and the tail kept or dropped; the same lengths and real counts."""
    kw = dict(LOADER, fea_path=fea16, seed=3, shuffle=True,
              drop_last=drop_last, prefetch=prefetch, process_index=index,
              process_count=count)
    port = streaming.StreamingGraphLoader(pool, 5, **kw)
    ref = jstreaming.StreamingGraphLoader(pool, 5, **kw)
    assert len(port) == len(ref)
    epochs = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n, targets = 0, []
        for b, jb in zip(port, ref, strict=True):
            assert port.last_counts == ref.last_counts
            _equal_batches(b, jb, f"epoch {epoch}")
            targets.append(b.target.numpy().tobytes())
            n += 1
        assert n == len(port)
        epochs.append(targets)
    assert epochs[0] != epochs[1]


@pytest.mark.parametrize("edge_shards,index,count", [(1, 0, 1), (2, 0, 1),
                                                     (1, 1, 2)])
def test_streaming_parallel_loader_equals_cgat_tpu(pool, fea16, edge_shards,
                                                   index, count):
    """Groups of D = 2 batches from the stream, stacked with group-wide
    shapes (edge-sharded with 2 shards, or a process's replica row of 2
    processes): field for field cgat_tpu's over two epochs."""
    def make(group_cls, module):
        stream = module.StreamingGraphLoader(pool, 4, **LOADER,
                                             fea_path=fea16, seed=5,
                                             prefetch=False)
        return group_cls(stream, 2, edge_shards=edge_shards,
                         process_index=index, process_count=count)

    port = make(StreamingParallelLoader, streaming)
    ref = make(JStreamingParallel, jstreaming)
    assert len(port) == len(ref) == 6
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for b, jb in zip(port, ref, strict=True):
            assert port.last_counts == ref.last_counts
            assert b.target.shape[0] == 2 // count
            _equal_batches(b, jb, f"epoch {epoch}")
            n += 1
        assert n == 6
    with pytest.raises(ValueError, match="not divisible"):
        StreamingParallelLoader(port.stream, 3, process_count=2)


def test_prefetch_loader_is_transparent_and_raises(pool, fea16):
    """The same batches and ``last_counts`` as the loader it wraps (and as
    cgat_tpu's prefetcher), ``set_epoch`` and ``len`` passed through; an
    error of the producer is raised in the consumer; leaving early joins
    the producer thread."""
    graphs = random_graphs(0, 23, n_atoms_range=(3, 7), max_nbr=6,
                           orig_fea=16)

    def run(wrap):
        loader = GraphLoader(graphs, 4, shuffle=True, seed=7, max_nbr=6,
                             node_bucket=8)
        if wrap is not None:
            loader = wrap(loader)
        assert len(loader) == 5
        out = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            for b in loader:
                out.append((b, dict(loader.last_counts)))
        return out

    bare, wrapped, jax_wrapped = (run(None), run(PrefetchLoader),
                                  run(JPrefetchLoader))
    assert len(bare) == len(wrapped) == len(jax_wrapped) == 10
    for (b, c), (w, wc), (_, jc) in zip(bare, wrapped, jax_wrapped):
        assert c == wc == jc
        for name in b.__dataclass_fields__:
            assert torch.equal(getattr(b, name), getattr(w, name)), name

    class Boom:
        def __iter__(self):
            yield 1
            raise RuntimeError("collate failed")

    it = iter(PrefetchLoader(Boom()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="collate failed"):
        next(it)
    before = threading.active_count()
    for _ in zip(range(2), PrefetchLoader(range(100), depth=1)):
        pass
    assert threading.active_count() == before
    assert not any(t.name == "PrefetchLoader" for t in threading.enumerate())


def _losses(run_dir, key):
    return [r[key] for r in map(json.loads, open(
        os.path.join(run_dir, "metrics.jsonl")).read().splitlines())
        if key in r]


def test_fit_with_the_prefetcher_is_bit_equal(tmp_path, monkeypatch):
    """``fit`` (and its validation) through the prefetcher and without it:
    the same losses and validation MAE, bit for bit."""
    graphs = random_graphs(0, 40, n_atoms_range=(3, 7), max_nbr=6,
                           orig_fea=16)
    tkw = dict(batch_size=4, node_bucket=8, max_nbr=6, num_comp_slots=8,
               learning_rate=3e-3, check_val_every_n_epoch=1, epochs=2,
               ckpt_dir=str(tmp_path))
    runs = {}
    for name in ("prefetch", "inline"):
        if name == "inline":
            monkeypatch.setattr(trainer_module, "PrefetchLoader",
                                lambda loader: loader)
        t = Trainer(TrainerConfig(**tkw, run_name=name),
                    CGATConfig(**dict(TINY, neighbor_number=6)), graphs,
                    device="cpu")
        t.fit()
        run = os.path.join(tmp_path, "runs", name)
        runs[name] = (_losses(run, "train_loss"), _losses(run, "val_mae"),
                      t.predict(t.test_graphs).tobytes())
    assert runs["prefetch"] == runs["inline"]
    assert len(runs["inline"][0]) == 2


def _streaming_cfg(pool, val_dir, fea16, tmp_path, **kw):
    return dict(data_path=pool, val_path=val_dir, streaming=True,
                target="e_above_hull", fea_path=fea16, batch_size=4,
                node_bucket=64, max_nbr=4, check_val_every_n_epoch=1,
                learning_rate=3e-3, clr=False, run_name="stream",
                ckpt_dir=str(tmp_path), **kw)


def test_streaming_fit_matches_cgat_tpu(pool, val_dir, fea16, tmp_path):
    """cgat_tpu's streaming Trainer and the port's on the same shards,
    config and initial weights, 2 epochs validated each epoch: the same
    normalisation, composition slots and validation set; each epoch's
    val_mae to 1e-3 relative (the anchor's tolerance)."""
    tkw = _streaming_cfg(pool, val_dir, fea16, tmp_path, epochs=2)
    jt = JTrainer(JTrainerConfig(**{**tkw, "ckpt_dir": str(tmp_path / "jax")}),
                  JConfig(**TINY))
    t = Trainer(TrainerConfig(**{**tkw, "ckpt_dir": str(tmp_path / "port")}),
                CGATConfig(**TINY), device="cpu")
    assert (t.mean, t.std) == (jt.mean, jt.std)
    assert t.cfg.num_comp_slots == jt.cfg.num_comp_slots
    assert t.train_graphs == [] and [g.cry_id for g in t.val_graphs] == [
        g.cry_id for g in jt.val_graphs]
    state = jt.init_state()
    t.init_state(state_dict_from_jax(jax.tree.map(np.array, state.params),
                                     CGATConfig(**TINY)))
    jt.fit(state)
    t.fit()
    runs = {k: str(tmp_path / k / "runs" / "stream") for k in ("jax", "port")}
    val = {k: _losses(r, "val_mae") for k, r in runs.items()}
    assert len(val["port"]) == len(val["jax"]) == 2
    np.testing.assert_allclose(val["port"], val["jax"], rtol=1e-3)
    steps = {k: [r["step"] for r in map(json.loads, open(os.path.join(
        r, "metrics.jsonl")).read().splitlines()) if "val_mae" in r]
        for k, r in runs.items()}
    assert steps["port"] == steps["jax"] == [12, 24]


@pytest.mark.parametrize("k", [1, 2])
def test_streaming_resume_is_exact(pool, val_dir, fea16, tmp_path, k):
    """A streaming run of 3 epochs, and one of 1 epoch resumed to 3: the
    same train losses and validation MAE bit for bit (the same batches in
    the same order), with single steps and with groups of 2 steps."""
    runs = {}
    for name, first in (("straight", 3), ("resumed", 1)):
        tkw = _streaming_cfg(pool, val_dir, fea16, tmp_path / name,
                             steps_per_dispatch=k, epochs=3)
        t = Trainer(TrainerConfig(**tkw), CGATConfig(**TINY), device="cpu")
        t.fit(epochs=first)
        run = str(tmp_path / name / "runs" / "stream")
        if first < 3:
            t, meta = resume_trainer(run, device="cpu")
            assert t.cfg.streaming and t.train_graphs == []
            t.fit(epochs=3, start_epoch=meta["epoch"] + 1,
                  best_val=meta["best_val"], plateau_state=meta["plateau"],
                  last_val_mae=meta["val_mae"])
        assert t.step == 3 * 12
        runs[name] = (_losses(run, "train_loss"), _losses(run, "val_mae"))
    assert runs["resumed"] == runs["straight"]
    assert len(runs["straight"][0]) == 3
