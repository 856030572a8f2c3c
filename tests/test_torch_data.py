"""The port's collate and synthetic graphs against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

from cgat_tpu.data import batching as jbatching
from cgat_tpu.data import synthetic as jsynthetic
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collate_matches_jax(seed):
    graphs = synthetic.random_graphs(seed, 7, n_atoms_range=(2, 9),
                                     max_nbr=6, orig_fea=12)
    jgraphs = jsynthetic.random_graphs(seed, 7, n_atoms_range=(2, 9),
                                       max_nbr=6, orig_fea=12)
    got = collate(graphs, max_nbr=6, node_bucket=8)
    _assert_same_batch(got, jbatching.collate(jgraphs, max_nbr=6,
                                              node_bucket=8))
    assert got.edge_dst_offn.shape == (got.num_node_slots + OFFN_MARGIN + 1,)


def test_collate_unary_crystals_match_jax():
    # a one-atom crystal (self-edge) and a one-species crystal
    rng = np.random.default_rng(3)
    graphs = [synthetic.random_graph(rng, n_atoms=1, max_nbr=4, orig_fea=8),
              synthetic.random_graph(rng, n_atoms=5, max_nbr=4, orig_fea=8,
                                     n_species=1)]
    rng = np.random.default_rng(3)
    jgraphs = [jsynthetic.random_graph(rng, n_atoms=1, max_nbr=4, orig_fea=8),
               jsynthetic.random_graph(rng, n_atoms=5, max_nbr=4, orig_fea=8,
                                       n_species=1)]
    assert graphs[1].comp_fea.shape[0] == 1
    _assert_same_batch(collate(graphs, max_nbr=4, node_bucket=8),
                       jbatching.collate(jgraphs, max_nbr=4, node_bucket=8))


def test_collate_explicit_slots_match_jax():
    kw = dict(num_graphs=8, num_node_slots=96, num_edge_slots=96 * 24,
              num_comp_slots=9, max_nbr=24, orig_fea=16)
    graphs = synthetic.random_graphs(5, 6, n_atoms_range=(8, 16), max_nbr=24,
                                     orig_fea=16, full_degree=True)
    jgraphs = jsynthetic.random_graphs(5, 6, n_atoms_range=(8, 16),
                                       max_nbr=24, orig_fea=16,
                                       full_degree=True)
    got = collate(graphs, **kw)
    _assert_same_batch(got, jbatching.collate(jgraphs, **kw))
    assert (got.num_graphs, got.num_node_slots, got.num_edge_slots) == (
        8, 96, 96 * 24)
    # padding is a False suffix pointing at the last node slot
    e = int(got.edge_mask.sum())
    assert got.edge_mask[:e].all() and not got.edge_mask[e:].any()
    assert (got.edge_dst[e:] == 95).all() and (got.edge_src[e:] == 95).all()


def test_collate_max_degree_matches_jax():
    graphs = synthetic.random_graphs(4, 3, max_nbr=5, orig_fea=8)
    jgraphs = jsynthetic.random_graphs(4, 3, max_nbr=5, orig_fea=8)
    kw = dict(max_nbr=5, node_bucket=16, max_degree=4)
    _assert_same_batch(collate(graphs, **kw), jbatching.collate(jgraphs, **kw))


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


def test_batch_to_moves_every_field():
    batch = collate(synthetic.random_graphs(0, 2, max_nbr=4, orig_fea=8),
                    max_nbr=4, node_bucket=8)
    moved = batch.to(torch.device("cpu"))
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(moved, f.name), getattr(batch, f.name))
