"""The port's collate and synthetic graphs against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

from cgat_tpu.data import batching as jbatching
from cgat_tpu.data import synthetic as jsynthetic
from cgat_tpu_torch import native
from cgat_tpu_torch.data import OFFN_MARGIN, CrystalBatch, collate
from cgat_tpu_torch.data import synthetic


def _assert_same_batch(got: CrystalBatch, want):
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None:           # halo fields: edge-sharded collates only
            assert not hasattr(got, f.name), f.name
            continue
        g = getattr(got, f.name)
        assert isinstance(g, torch.Tensor), f.name
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (f.name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


def _unary(m):
    # a one-atom crystal (self-edge) and a one-species crystal
    rng = np.random.default_rng(3)
    return [m.random_graph(rng, n_atoms=1, max_nbr=4, orig_fea=8),
            m.random_graph(rng, n_atoms=5, max_nbr=4, orig_fea=8,
                           n_species=1)]


def _one_atom(m):
    rng = np.random.default_rng(4)
    return [m.random_graph(rng, n_atoms=1, max_nbr=4, orig_fea=8)
            for _ in range(5)]


def _wide(g):
    """The crystal as ``load_prepared`` and pool views may give it: int64
    and non-contiguous edge arrays, f64 and non-contiguous rows."""
    def strided(a, dtype):
        out = np.zeros((2,) + a.shape, dtype)
        out[0] = a
        return out[0] if a.ndim == 2 else np.repeat(out[0], 2)[::2]
    return dataclasses.replace(
        g, edge_src=strided(g.edge_src, np.int64),
        edge_dst=np.asfortranarray(g.edge_dst.astype(np.int64)),
        edge_shell=strided(g.edge_shell, np.int64),
        atom_fea=np.asfortranarray(g.atom_fea.astype(np.float64)),
        comp_fea=strided(g.comp_fea, np.float64).T.copy().T,
        comp_weight=strided(g.comp_weight, np.float32))


def _full_slots(m):
    return m.random_graphs(6, 5, n_atoms_range=(3, 7), max_nbr=4,
                           orig_fea=8, full_degree=True)


# each case: (graphs of one package's synthetic module, collate keywords);
# the port's graphs may be recast by a third entry
COLLATE_CASES = {
    **{str(seed): (lambda m, seed=seed: m.random_graphs(
        seed, 7, n_atoms_range=(2, 9), max_nbr=6, orig_fea=12),
        dict(max_nbr=6, node_bucket=8)) for seed in (0, 1, 2)},
    "unary": (_unary, dict(max_nbr=4, node_bucket=8)),
    "explicit_slots": (lambda m: m.random_graphs(
        5, 6, n_atoms_range=(8, 16), max_nbr=24, orig_fea=16,
        full_degree=True), dict(num_graphs=8, num_node_slots=96,
                                num_edge_slots=96 * 24, num_comp_slots=9,
                                max_nbr=24, orig_fea=16)),
    "max_degree": (lambda m: m.random_graphs(4, 3, max_nbr=5, orig_fea=8),
                   dict(max_nbr=5, node_bucket=16, max_degree=4)),
    # GraphLoader's settings at the GP's batch
    "loader_512": (lambda m: m.random_graphs(
        8, 512, n_atoms_range=(4, 21), max_nbr=24, full_degree=True),
        dict(num_graphs=512, max_nbr=24, node_bucket=64, num_comp_slots=12,
             max_degree=24)),
    # real atoms in every node slot: slot N - 1 is an atom, and the
    # padding edges (source N - 1) sort after its edges
    "every_slot_real": (_full_slots, dict(
        num_graphs=6, num_node_slots=sum(
            g.n_atoms for g in _full_slots(synthetic)),
        num_edge_slots=1000, max_nbr=4, orig_fea=8)),
    "empty": (lambda m: [], dict(max_nbr=4, node_bucket=8)),
    "empty_slots": (lambda m: [], dict(num_graphs=3, num_comp_slots=2,
                                       max_nbr=4, orig_fea=8)),
    "one_atom": (_one_atom, dict(max_nbr=4, node_bucket=8)),
    "int64_strided": (lambda m: m.random_graphs(
        9, 6, n_atoms_range=(2, 9), max_nbr=6, orig_fea=12),
        dict(max_nbr=6, node_bucket=8), _wide),
}


@pytest.mark.parametrize("case", list(COLLATE_CASES))
def test_collate_matches_jax(case):
    make, kw, *recast = COLLATE_CASES[case]
    graphs = make(synthetic)
    for fn in recast:
        graphs = [fn(g) for g in graphs]
    got = collate(graphs, **kw)
    _assert_same_batch(got, jbatching.collate(make(jsynthetic), **kw))
    N, e = got.num_node_slots, int(got.edge_mask.sum())
    assert got.edge_dst_offn.shape == (N + OFFN_MARGIN + 1,)
    # padding is a False suffix pointing at the last node slot
    assert got.edge_mask[:e].all() and not got.edge_mask[e:].any()
    assert (got.edge_dst[e:] == N - 1).all()
    assert (got.edge_src[e:] == N - 1).all()
    if case == "explicit_slots":
        assert (got.num_graphs, N, got.num_edge_slots) == (8, 96, 96 * 24)
    if case == "every_slot_real":
        assert bool(got.node_mask.all()) and got.num_edge_slots > e
        assert (got.edge_src_sorted[e:] == N - 1).all()
    if case == "unary":
        assert graphs[1].comp_fea.shape[0] == 1


def test_random_graphs_match_jax():
    for g, j in zip(synthetic.random_graphs(9, 4, full_degree=True),
                    jsynthetic.random_graphs(9, 4, full_degree=True)):
        for f in ("atom_fea", "edge_src", "edge_dst", "edge_shell",
                  "comp_fea", "comp_weight"):
            np.testing.assert_array_equal(getattr(g, f), getattr(j, f))
        assert (g.target, g.cry_id) == (j.target, j.cry_id)


def test_collate_rejects_overflow():
    graphs = synthetic.random_graphs(0, 3, max_nbr=4, orig_fea=8)
    with pytest.raises(ValueError):
        collate(graphs, num_graphs=2, max_nbr=4)
    with pytest.raises(ValueError):
        collate(graphs, num_node_slots=4, max_nbr=4)
    with pytest.raises(ValueError):
        collate(graphs, num_comp_slots=0, max_nbr=4)


@pytest.mark.parametrize("bad", [("edge_dst", 5), ("edge_src", 5),
                                 ("edge_src", -1), ("edge_dst", 2 ** 32 + 1)])
def test_collate_rejects_edges_outside_their_crystal(bad):
    """An edge id outside its crystal's atoms raises, names the crystal and
    writes nothing out of bounds (ids far past the batch too, and int64 ids
    that would fall inside a crystal if cut to int32)."""
    field, value = bad
    graphs = synthetic.random_graphs(1, 4, n_atoms_range=(5, 6), max_nbr=4,
                                     orig_fea=8)
    arr = getattr(graphs[2], field).astype(np.int64)
    arr[3] = value
    graphs[2] = dataclasses.replace(graphs[2], **{field: arr})
    before = native.collate_stats()
    with pytest.raises(ValueError, match="crystal 2 has an edge"):
        collate(graphs, max_nbr=4, node_bucket=8)
    assert native.collate_stats() == before
    graphs[2] = dataclasses.replace(graphs[2], **{field: np.clip(arr, 0, 4)})
    collate(graphs, max_nbr=4, node_bucket=8)


def test_collate_counts_its_batches():
    graphs = synthetic.random_graphs(2, 5, max_nbr=4, orig_fea=8)
    before = native.collate_stats()
    collate(graphs, max_nbr=4, node_bucket=8, num_graphs=8)
    after = native.collate_stats()
    assert after["batches"] == before["batches"] + 1
    assert after["crystals"] == before["crystals"] + 5


def test_batch_to_moves_every_field():
    batch = collate(synthetic.random_graphs(0, 2, max_nbr=4, orig_fea=8),
                    max_nbr=4, node_bucket=8)
    moved = batch.to(torch.device("cpu"))
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(moved, f.name), getattr(batch, f.name))
