"""The port's data slice against cgat_tpu on the CPU: prototype structures,
the bundled embedding, the periodic kNN (native and numpy), prepare, the
prepare cache, loading prepared datasets, and the host-side meters."""
import contextlib
import gzip
import pickle

import numpy as np
import pytest

from cgat_tpu.data import dataset as jdataset
from cgat_tpu.data import embedding as jembedding
from cgat_tpu.data import featurizer as jfeaturizer
from cgat_tpu.data import structures as jstructures
from cgat_tpu.training import meters as jmeters
from cgat_tpu.utils import profiling as jprofiling
from cgat_tpu_torch import native
from cgat_tpu_torch.data import dataset, embedding, featurizer, structures
from cgat_tpu_torch.data.batching import collate
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.native import build as native_build
from cgat_tpu_torch.training import meters
from cgat_tpu_torch.utils import profiling

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,n,kinds", [(0, 12, None), (7, 9, ("cscl",
                                                                  "fluorite"))])
def test_random_structures_equal_cgat_tpu(seed, n, kinds):
    got = structures.random_structures(seed, n, kinds=kinds)
    want = jstructures.random_structures(seed, n, kinds=kinds)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["lattice"], b["lattice"])
        np.testing.assert_array_equal(a["frac_coords"], b["frac_coords"])
        assert (a["species"], a["composition"], a["data"]) == (
            b["species"], b["composition"], b["data"])


def test_bundled_embedding_equals_cgat_tpu():
    name = "matscholar-embedding.json"
    port = ROOT / "cgat_tpu_torch" / "data" / "embeddings" / name
    ref = ROOT / "cgat_tpu" / "data" / "embeddings" / name
    assert port.read_bytes() == ref.read_bytes()
    for path in (None, name):       # the default, and a bundled file name
        got, want = (embedding.load_featuriser(path),
                     jembedding.load_featuriser(path))
        assert got.allowed_types == want.allowed_types
        assert got.embedding_size == want.embedding_size == 200
        symbols = sorted(want.allowed_types)
        np.testing.assert_array_equal(got.matrix(symbols),
                                      want.matrix(symbols))
    with pytest.raises(FileNotFoundError):
        embedding.load_featuriser("no-such-embedding.json")


def _random_triclinic(seed):
    """A skewed cell with bounded conditioning and 1 to 3 atoms (the
    sampler of tests/test_featurizer_oracle.py)."""
    rng = np.random.default_rng(seed)
    while True:
        A = rng.uniform(-4.0, 4.0, (3, 3))
        lengths = np.linalg.norm(A, axis=1)
        if (abs(np.linalg.det(A)) >= 6.0 and lengths.min() >= 1.5
                and lengths.max() <= 7.0 and np.linalg.cond(A) <= 40.0):
            return A, rng.uniform(0.0, 1.0, (int(rng.integers(1, 4)), 3))


_CELLS = {
    # (lattice, frac, radius), after tests/test_featurizer_oracle.py and
    # tests/test_featurizer_golden.py
    "triclinic_a": (*_random_triclinic(20260820), 9.0),
    "triclinic_b": (*_random_triclinic(3), 9.0),
    "high_shear": (np.array([[3.0, 0.0, 0.0], [2.7, 0.9, 0.0],
                             [2.5, 0.8, 1.1]]),
                   np.array([[0.0, 0.0, 0.0], [0.37, 0.61, 0.22]]), 9.0),
    "sliver": (np.array([[6.5, 0.0, 0.0], [3.1, 5.8, 0.0],
                         [0.9, 0.7, 0.8]]), np.array([[0.1, 0.2, 0.3]]), 9.0),
    "sheared_cubic": (np.array([[1, 0, 0], [2, 1, 0], [5, 3, 1]], float)
                      @ (np.eye(3) * 3.0), np.zeros((1, 3)), 9.0),
    "sc_tie": (np.eye(3) * 3.0, np.zeros((1, 3)), 18.0),
    "bcc_tie": (np.eye(3) * 3.0, np.array([[0, 0, 0], [0.5, 0.5, 0.5]]),
                18.0),
    "fcc_tie": (np.eye(3) * 4.0, np.array([[0, 0, 0], [0.5, 0.5, 0],
                                           [0.5, 0, 0.5], [0, 0.5, 0.5]]),
                18.0),
    "bcc_sub_threshold": (np.eye(3) * 3.0,
                          np.array([[0, 0, 0], [0.5 + 1e-10, 0.5, 0.5]]),
                          18.0),
    "rejected": (np.eye(3) * 25.0, np.array([[0, 0, 0], [0.5, 0.5, 0.5]]),
                 9.0),
}


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("cell", sorted(_CELLS))
def test_periodic_neighbors_equal_cgat_tpu(cell, use_native):
    lattice, frac, radius = _CELLS[cell]
    got = featurizer.periodic_neighbors(lattice, frac, radius=radius,
                                        use_native=use_native)
    want = jfeaturizer.periodic_neighbors(lattice, frac, radius=radius,
                                          use_native=use_native)
    assert (got is None) == (want is None) == (cell == "rejected")
    if want is None:
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)
    assert got[0].dtype == got[1].dtype == np.int64


def test_native_equals_numpy_on_prototypes():
    """The port's C++ core against its numpy oracle on perturbed prototype
    crystals: the same neighbours, shells and distances (1e-9, as
    tests/test_native.py holds cgat_tpu's)."""
    for s in structures.random_structures(11, 10):
        nat = featurizer.periodic_neighbors(s["lattice"], s["frac_coords"])
        ref = featurizer.periodic_neighbors(s["lattice"], s["frac_coords"],
                                            use_native=False)
        np.testing.assert_array_equal(nat[0], ref[0])
        np.testing.assert_array_equal(nat[1], ref[1])
        np.testing.assert_allclose(nat[2], ref[2], rtol=0, atol=1e-9)


@pytest.mark.parametrize("fault", ["source", "compiler"])
def test_failed_native_build_raises(fault, tmp_path, monkeypatch):
    """A build that fails raises with the compiler's message, and the
    default neighbor search and the collate raise with it rather than
    dropping to numpy. The library holds both sources: a fault in either
    fails it."""
    if fault == "source":
        bad = tmp_path / "collate.cc"
        bad.write_text("extern \"C\" int cgat_collate( { }\n")
        monkeypatch.setattr(native_build, "SRCS",
                            (native_build.SRCS[0], bad))
        match = "error"
    else:
        monkeypatch.setattr(native_build, "CXX", "no-such-c++-compiler")
        match = "no-such-c\\+\\+-compiler"
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=match):
        native_build.build()
    lattice, frac, _ = _CELLS["bcc_tie"]
    with pytest.raises(RuntimeError, match="native build failed"):
        featurizer.periodic_neighbors(lattice, frac)
    with pytest.raises(RuntimeError, match="native build failed"):
        collate(random_graphs(0, 2, max_nbr=4, orig_fea=8), max_nbr=4)
    assert featurizer.periodic_neighbors(lattice, frac,
                                         use_native=False) is not None
    assert not list((tmp_path / "build").glob("*.so"))


def _assert_prepared_equal(got, want):
    assert got.keys() == want.keys()
    assert got["batch_ids"] == want["batch_ids"]
    assert list(got["batch_comp"]) == list(want["batch_comp"])
    assert got["target"].keys() == want["target"].keys()
    for k in want["target"]:
        np.testing.assert_array_equal(got["target"][k], want["target"][k])
    assert got["input"].shape == want["input"].shape
    for row in range(3):
        for a, b in zip(got["input"][row], want["input"][row], strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["comps"], want["comps"], strict=True):
        assert list(a) == list(b)


def _structures():
    """Prototype crystals and one that is rejected (too sparse)."""
    entries = structures.random_structures(4, 8, noise=0.01)
    entries.insert(3, {"lattice": np.eye(3) * 40.0,
                       "frac_coords": np.zeros((1, 3)), "species": ["Na"],
                       "data": {"id": "sparse", "e_above_hull": 0.0,
                                "e_form": 0.0}})
    return entries


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("cached", [False, True])
def test_build_dataset_prepare_equals_cgat_tpu(workers, cached, tmp_path):
    kw = dict(max_neighbor_number=12, progress=False,
              target_property=("e_above_hull", "e_form", "volume"))
    want = jfeaturizer.build_dataset_prepare(_structures(), **kw)
    cache = str(tmp_path / "cache") if cached else None
    # the rejection warns in the process that featurises it
    with (pytest.warns(UserWarning, match="sparse") if not workers
          else contextlib.nullcontext()):
        got = featurizer.build_dataset_prepare(_structures(), workers=workers,
                                               cache=cache, **kw)
    assert len(got["batch_ids"]) == 8
    _assert_prepared_equal(got, want)
    if cached:          # replayed from the warm cache, serially
        warm = featurizer.FeaturizationCache(cache)
        again = featurizer.build_dataset_prepare(_structures(), cache=warm,
                                                 **kw)
        assert (warm.hits, warm.misses) == (9, 0)
        _assert_prepared_equal(again, want)


def _assert_graphs_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for name in ("atom_fea", "edge_src", "edge_dst", "edge_shell",
                     "comp_fea", "comp_weight"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert (a.target, a.cry_id, a.composition) == (
            b.target, b.cry_id, b.composition)


@pytest.fixture(scope="module")
def prepared():
    return jfeaturizer.build_dataset_prepare(
        jstructures.random_structures(2, 7), max_neighbor_number=12,
        progress=False, target_property=("e_above_hull", "volume"))


@pytest.mark.parametrize("fmt", [0, 1])
@pytest.mark.parametrize("target", ["e_above_hull", "volume"])
def test_load_prepared_equals_cgat_tpu(prepared, fmt, target, tmp_path):
    data = dict(prepared)
    if fmt == 1:        # the reference's other layout: (n, 3) rows
        n = len(data["batch_ids"])
        rows = np.empty((n, 3), dtype=object)
        for i in range(n):
            for r in range(3):
                rows[i, r] = data["input"][r][i]
        data["input"] = rows
    path = tmp_path / "prep.pickle.gz"
    with gzip.open(path, "wb") as f:
        pickle.dump(data, f)
    kw = dict(max_neighbor_number=8, target=target)
    got = dataset.load_prepared(str(path), **kw)
    _assert_graphs_equal(got, jdataset.load_prepared(str(path), **kw))
    if target == "volume":      # stays per-atom (data.py:139-144)
        assert got[0].target == pytest.approx(
            prepared["target"]["volume"][0])


def test_load_dataset_dir_equals_cgat_tpu(prepared, tmp_path, capsys):
    for name, data in (("a.pickle.gz", prepared), ("b.pickle.gz", prepared)):
        with gzip.open(tmp_path / name, "wb") as f:
            pickle.dump(data, f)
    (tmp_path / "c.pickle.gz").write_bytes(b"not a gzipped pickle")
    kw = dict(max_neighbor_number=12, target="e_above_hull")
    got = dataset.load_dataset_dir(str(tmp_path), **kw)
    assert "c.pickle.gz could not be loaded" in capsys.readouterr().out
    _assert_graphs_equal(got, jdataset.load_dataset_dir(str(tmp_path), **kw))
    assert len(got) == 14
    with pytest.raises(FileNotFoundError):
        dataset.load_dataset_dir(str(tmp_path / "empty"))


def test_prepare_graphs_equals_cgat_tpu(tmp_path):
    entries = structures.random_structures(9, 6)
    kw = dict(target="e_form", max_nbr=12)
    _assert_graphs_equal(
        featurizer.prepare_graphs(entries, cache=str(tmp_path), **kw),
        jfeaturizer.prepare_graphs(entries, **kw))


def test_loader_counts_and_meters_equal_cgat_tpu():
    """``GraphLoader.last_counts``, ``ThroughputMeter`` and the metric
    helpers agree with cgat_tpu's on the same inputs."""
    graphs = random_graphs(3, 10, n_atoms_range=(3, 7), max_nbr=6,
                           orig_fea=16)
    loader = dataset.GraphLoader(graphs, 4, max_nbr=6, node_bucket=8,
                                 drop_last=False)
    counts = []
    for _ in loader:
        counts.append(dict(loader.last_counts))
    assert counts == [{"edges": sum(len(g.edge_src) for g in graphs[i:i + 4]),
                       "graphs": len(graphs[i:i + 4])} for i in (0, 4, 8)]
    meter, jmeter = profiling.ThroughputMeter(), jprofiling.ThroughputMeter()
    for c in counts:
        meter.update(**c)
        jmeter.update(**c)
    got, want = meter.rates(), jmeter.rates()
    assert got.keys() == want.keys() == {"edges_per_sec", "graphs_per_sec",
                                         "steps_per_sec", "epoch_time"}
    assert (meter.steps, meter.edges, meter.graphs) == (
        jmeter.steps, jmeter.edges, jmeter.graphs)
    avg, javg = meters.AverageMeter(), jmeters.AverageMeter()
    norm, jnorm = meters.Normalizer(), jmeters.Normalizer()
    values = [0.5, 2.0, -1.25, 3.0]
    for i, v in enumerate(values):
        avg.update(v, n=i + 1)
        javg.update(v, n=i + 1)
    norm.fit(values)
    jnorm.fit(values)
    assert (avg.avg, avg.sum, avg.count) == (javg.avg, javg.sum, javg.count)
    assert norm.state_dict() == jnorm.state_dict()
    assert norm.denorm(norm.norm(1.5)) == jnorm.denorm(jnorm.norm(1.5))
