"""The port's active-learning bookkeeping (``cgat_tpu_torch/tools``, the
numpy modules) against ``cgat_tpu.tools`` on the same seeds and files:
the Metropolis chains, the periodic table, the element statistics, the
pool scan and both samplers, the shard surgery, the annotation, the
additional-data featurisation and the element-correlation CLI. Each
output must equal cgat_tpu's exactly (the same numpy calls in the same
order); the additional data's prepared pickles come from each package's
own featuriser, which are held equal elsewhere, so they must be equal too.
"""
import bz2
import json
import os

import numpy as np
import pytest
import torch

from cgat_tpu.tools import MarkovChain as JMarkovChain
from cgat_tpu.tools import additional_data as jadditional
from cgat_tpu.tools import element_correlation as jec_cli
from cgat_tpu.tools import embeddings as jembeddings
from cgat_tpu.tools import sample as jsample
from cgat_tpu.tools import shards as jshards
from cgat_tpu.tools.annotate import annotate_volume_and_ids as jannotate
from cgat_tpu.tools.periodic import SYMBOL_TO_Z as JSYMBOL_TO_Z
from cgat_tpu.tools.periodic import symbol_to_z as jsymbol_to_z
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.tools import MAX_Z, SYMBOL_TO_Z, MarkovChain
from cgat_tpu_torch.tools import additional_data, embeddings, sample, shards
from cgat_tpu_torch.tools import element_correlation as ec_cli
from cgat_tpu_torch.tools import symbol_to_z
from cgat_tpu_torch.tools.annotate import annotate_volume_and_ids


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test, as the other port test files pin (the
    featuriser's tensors are tiny); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_prepared(n, id_offset=0, seed=0):
    """A prepared dict of ``n`` entries (tests/test_tools.py's fixture)."""
    rng = np.random.default_rng(seed)
    inputs = np.empty((3, n), dtype=object)
    elements = ["Na", "Cl", "K", "O", "Fe"]
    comps, batch_comp = [], []
    for i in range(n):
        na = int(rng.integers(2, 5))
        inputs[0, i] = rng.integers(1, 5, (na, 4))
        inputs[1, i] = np.repeat(np.arange(na)[:, None], 4, 1)
        inputs[2, i] = rng.integers(0, na, (na, 4))
        els = [elements[int(x)] for x in rng.integers(0, 5, na)]
        comps.append(np.asarray(els, dtype=object))
        cnt = {}
        for e in els:
            cnt[e] = cnt.get(e, 0) + 1
        batch_comp.append(" ".join(f"{k}{v}" for k, v in cnt.items()))
    return {
        "input": inputs,
        "batch_ids": [[f"{id_offset + i},225"] for i in range(n)],
        "batch_comp": np.asarray(batch_comp, dtype=object),
        "target": {"e_above_hull": rng.standard_normal(n)},
        "comps": np.asarray(comps, dtype=object),
    }


def assert_same(got, want, where="root"):
    """Recursive exact equality of prepared dicts, lists and arrays (object
    arrays element by element)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray) and want.dtype == object:
        got = np.asarray(got, dtype=object)
        assert got.shape == want.shape, where
        for i, (g, w) in enumerate(zip(got.reshape(-1), want.reshape(-1))):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(got, want, err_msg=where)
        assert np.asarray(got).dtype == want.dtype, where
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def _pool(tmp_path, name, pkg_shards, sizes=(20, 20, 20)):
    """Shards of make_prepared dicts written by ``pkg_shards``."""
    pool = str(tmp_path / name)
    os.makedirs(pool)
    offset = 0
    for i, n in enumerate(sizes):
        pkg_shards.save_pickle(make_prepared(n, id_offset=offset, seed=i),
                               pkg_shards.shard_path(i, pool))
        offset += n
    return pool


def _written(path):
    return [jshards.load_pickle(p) for _, p in jshards.iter_shards(path)]


# ------------------------------------------------------------- the chains

@pytest.mark.parametrize("seed", [0, 5])
def test_markov_chain_equals_cgat_tpu(seed):
    def density(x):
        return 1.0 if x > 0.5 else 0.25

    def propose(rng):
        return rng.random()

    got = MarkovChain(density, propose, seed=seed).step(700)
    want = JMarkovChain(density, propose, seed=seed).step(700)
    np.testing.assert_array_equal(got.chain, want.chain)
    assert got.acceptance_rate == want.acceptance_rate


@pytest.mark.parametrize("weights,seed,start", [
    ([0.0, 1.0, 3.0, 6.0], 3, None), ([1.0, 2.0, 3.0], 7, None),
    ([0.5, 0.0, 2.0, 0.0, 1.0], 11, 4)])
def test_discrete_chain_equals_cgat_tpu(weights, seed, start):
    got = MarkovChain.discrete(weights, seed=seed, start=start)
    want = JMarkovChain.discrete(weights, seed=seed, start=start)
    for n in (1, 50, 949):
        got.step(n)
        want.step(n)
    np.testing.assert_array_equal(got.chain, want.chain)
    assert len(got) == 1001 and list(got) == list(want)


def test_symbol_to_z_equals_cgat_tpu():
    assert SYMBOL_TO_Z == JSYMBOL_TO_Z and MAX_Z == 118
    for s in list(SYMBOL_TO_Z) + ["Fe2", "O12", "Og1"]:
        assert symbol_to_z(s) == jsymbol_to_z(s)


# ------------------------------------------------------------ the samples

def test_element_statistics_equal_cgat_tpu(tmp_path):
    pool = _pool(tmp_path, "pool", jshards)
    _, sets, _ = jsample.scan_pool(pool)
    sets += [{1, 8}, {1, 8}, {1, 17}, {26, 8}, {92}]
    for max_z in (MAX_Z, 92):
        got = sample.element_correlation(sets, max_z)
        want = jsample.element_correlation(sets, max_z)
        np.testing.assert_array_equal(got, want)
        for cap in (150.0, 3.0):
            np.testing.assert_array_equal(sample.element_weights(got, cap),
                                          jsample.element_weights(want, cap))
        f, g = sample.element_distribution(got), \
            jsample.element_distribution(want)
        assert [f(z) for z in range(max_z)] == [g(z) for z in range(max_z)]
    for comp in ("Na1 Cl1", "NaCl", "Fe2O3", ["K1 O2"]):
        assert sample.composition_elements(comp) == \
            jsample.composition_elements(comp)


@pytest.mark.parametrize("method,seed,n", [("random", 1, 10),
                                           ("random", 4, 25),
                                           ("metropolis", 2, 10),
                                           ("metropolis", 9, 30)])
def test_scan_and_samplers_equal_cgat_tpu(tmp_path, method, seed, n):
    pool = _pool(tmp_path, "pool", shards)
    exclude = {"0,225", "33,225"}
    got = sample.scan_pool(pool, exclude_ids=exclude)
    want = jsample.scan_pool(pool, exclude_ids=set(exclude))
    assert got == want and len(got[0]) == 58
    assert sample.scan_pool(pool, n_shards=2) == \
        jsample.scan_pool(pool, n_shards=2)
    if method == "random":
        chosen = sample.random_sample(got[0], n, seed=seed)
        assert chosen == jsample.random_sample(want[0], n, seed=seed)
    else:
        chosen = sample.metropolis_sample(*got, n, seed=seed)
        assert chosen == jsample.metropolis_sample(*want, n, seed=seed)
    assert 0 < len(chosen) <= n


def test_extract_sample_equals_cgat_tpu(tmp_path):
    pool = _pool(tmp_path, "pool", shards)
    ids = sample.scan_pool(pool)
    chosen = sample.metropolis_sample(*ids, 12, seed=3)
    got = sample.extract_sample(pool, str(tmp_path / "port"), chosen)
    want = jsample.extract_sample(pool, str(tmp_path / "jax"), set(chosen))
    assert_same(got, want)
    assert len(got["batch_ids"]) == len(chosen)
    assert_same(_written(str(tmp_path / "port")),
                _written(str(tmp_path / "jax")))
    assert sample.extract_sample(pool, str(tmp_path / "none"), set(),
                                 rewrite_pool=False) is None


# ------------------------------------------------------- the shard surgery

def test_shard_surgery_equals_cgat_tpu():
    a, b = make_prepared(9, seed=1), make_prepared(7, id_offset=9, seed=2)
    for idx in ([0, 3, 8], [4], []):
        assert_same(shards.select_entries(a, idx) if idx else a,
                    jshards.select_entries(a, idx) if idx else a)
        assert_same(shards.remove_entries(make_prepared(9, seed=1), idx),
                    jshards.remove_entries(make_prepared(9, seed=1), idx))
    assert_same(shards.merge_prepared([a, b]), jshards.merge_prepared([a, b]))
    for keep in (True, False):
        ids = {"1,225", "4,225", "99,225"}
        got = shards.remove_batch_ids(make_prepared(9, seed=1), ids,
                                      modify_batch_ids=keep)
        want = jshards.remove_batch_ids(make_prepared(9, seed=1),
                                        {"1,225", "4,225", "99,225"},
                                        modify_batch_ids=keep)
        assert_same(got, want)
        assert ids == ({"99,225"} if keep else {"1,225", "4,225", "99,225"})
    assert shards.shard_path(3, "/p") == jshards.shard_path(3, "/p")
    assert shards.numeric_id(["12,225"]) == jshards.numeric_id(["12,225"])


@pytest.mark.parametrize("inplace", [True, False])
def test_embedding_remove_batch_ids_equals_cgat_tpu(inplace):
    def data():
        rng = np.random.default_rng(0)
        return {"input": rng.standard_normal((6, 3)).astype(np.float32),
                "batch_ids": [[f"{i},1"] for i in range(6)],
                "batch_comp": np.asarray(list("abcdef"), dtype=object),
                "target": {"e": np.arange(6.0)},
                "comps": np.asarray(list("abcdef"), dtype=object)}
    ids = {"1,1", "3,1", "5,1"}
    assert_same(embeddings.remove_batch_ids(data(), set(ids),
                                            inplace=inplace),
                jembeddings.remove_batch_ids(data(), set(ids),
                                             inplace=inplace))


def test_unprepared_samples_equal_cgat_tpu(tmp_path):
    files = []
    for s in range(2):
        entries = random_structures(s, 6)
        for i, e in enumerate(entries):
            e["data"]["id"] = f"{s * 6 + i},1"
        files.append(str(tmp_path / f"raw{s}.pickle.gz"))
        shards.save_pickle(entries, files[-1])
    ids = {"1,1", "7,1", "11,1", "40,1"}
    got = shards.get_samples_from_unprepared_data(set(ids), files)
    want = jshards.get_samples_from_unprepared_data(set(ids), files)
    assert_same(got, want)
    assert [e["data"]["id"] for e in got] == ["1,1", "7,1", "11,1"]
    prepared = str(tmp_path / "p.pickle.gz")
    shards.save_pickle(make_prepared(4), prepared)
    assert shards.get_batch_ids(prepared) == jshards.get_batch_ids(prepared)


# --------------------------------------------------------- the annotation

def test_annotation_equals_cgat_tpu():
    def entries():
        out = random_structures(3, 8)
        out[2]["species"] = ["Na"] * len(out[2]["species"])  # a unary
        out[0]["data"]["id"] = "abc-spg225-x"
        out[1]["data"]["spg"] = 12
        out[3]["data"]["id"] = "no-group"
        return out
    for start, drop in ((0, True), (17, False)):
        got, nxt = annotate_volume_and_ids(entries(), start, drop)
        want, jnxt = jannotate(entries(), start, drop)
        assert nxt == jnxt
        assert_same(got, want)


# ------------------------------------------------- additional data and CLI

def _json_entries(structures):
    """The structures as pymatgen's ComputedStructureEntry dict layout."""
    return {"entries": [{
        "structure": {
            "lattice": {"matrix": np.asarray(s["lattice"]).tolist()},
            "sites": [{"abc": np.asarray(c).tolist(),
                       "species": [{"element": el, "occu": 1}]}
                      for c, el in zip(s["frac_coords"], s["species"])]},
        "data": {"id": f"{i},1", "e_above_hull_new": 0.01 * i,
                 "e-form": -0.1 * i}} for i, s in enumerate(structures)]}


def test_additional_data_equals_cgat_tpu(tmp_path):
    for comp, seed in (("AB", 0), ("A2B3C", 1)):
        d = tmp_path / "src" / comp / "annotated"
        os.makedirs(d)
        with bz2.open(d / f"batch-{seed:03d}.json.bz2", "wt") as f:
            json.dump(_json_entries(random_structures(seed, 5)), f)
    pattern = str(tmp_path / "src" / "*" / "annotated" / "*.json.bz2")
    kw = dict(max_neighbor_number=6)
    assert additional_data.prepare_additional_data(
        pattern, str(tmp_path / "port"), **kw) == 2
    assert jadditional.prepare_additional_data(
        pattern, str(tmp_path / "jax"), **kw) == 2
    for comp, seed in (("AB", 0), ("A2B3C", 1)):
        name = os.path.join(comp, f"batch-{seed:03d}.pickle.gz")
        got = shards.load_pickle(str(tmp_path / "port" / name))
        assert_same(got, jshards.load_pickle(str(tmp_path / "jax" / name)))
        assert len(got["batch_ids"]) == 5
        assert additional_data.get_composition(
            str(tmp_path / "src" / comp / "annotated" / "x.json.bz2")) == comp
    assert additional_data.get_file_name("/a/b/batch-007.json.bz2") == \
        jadditional.get_file_name("/a/b/batch-007.json.bz2")


def test_element_correlation_cli_equals_cgat_tpu(tmp_path, capsys):
    pool = _pool(tmp_path, "pool", shards, sizes=(15, 15))
    argv = ["--pool-dir", pool, "--top", "3", "--out"]
    assert ec_cli.main(argv + [str(tmp_path / "port.npz")]) == 0
    port_out = capsys.readouterr().out
    assert jec_cli.main(argv + [str(tmp_path / "jax.npz")]) == 0
    jax_out = capsys.readouterr().out
    got = np.load(tmp_path / "port.npz")["correlation"]
    np.testing.assert_array_equal(got,
                                  np.load(tmp_path / "jax.npz")["correlation"])
    assert got.shape == (MAX_Z, MAX_Z) and np.all(np.diag(got) == 0)
    assert port_out.replace("port.npz", "jax.npz") == jax_out
